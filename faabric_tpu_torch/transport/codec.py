"""Adaptive wire codecs: per-link codec choice and delta streams.

Counterpart of ``faabric_tpu/transport/codec.py``. Iterative workloads
(a parameter broadcast, a solver's sendrecv ping-pong) send nearly the
same buffer to the same peer round after round; the bulk plane
(``transport/bulk.py``) can send such a frame as a delta against one the
receiver already holds:

- ``WireCodecGovernor`` picks raw, delta or zlib for a link. Its verdict
  rides the bulk frame header (a codec byte and epochs), so the receiver
  decodes what the header says and never guesses. The leader ring's
  int8 quantisation (``mpi/quant.py``) resolves through it too.
- ``SenderDeltaCache`` keeps the last payloads sent on each (group,
  src, dst, channel) stream. A sampled XOR probe picks an epoch-tagged
  base; a frame with no good base ships full (zlib'd when its entropy
  says that pays) and becomes a base.
- ``ReceiverDeltaCache`` mirrors it. A delta whose base is missing,
  whose crc fails or whose decode blows up returns None: the bulk server
  NACKs, and the sender re-ships the same sequence number as a full
  frame. A torn base never decodes garbage and never stalls the stream.

Codec ids (the ``codec`` byte of a bulk frame): ``CODEC_RAW`` frames
never enter this module; ``CODEC_FULL`` carries the raw payload and
establishes base ``self_epoch``; ``CODEC_DELTA`` is the XOR+zlib command
stream of ``util/delta.py`` against ``base_epoch``, whose decode becomes
``self_epoch``; ``CODEC_ZLIB`` is a whole-payload zlib full frame.

Knobs, read as the reference reads them: ``FAABRIC_WIRE_CODEC`` (``auto``
by default; ``raw`` or ``off`` disables; ``delta`` or ``zlib`` forces a
codec on eligible bulk streams; ``quant`` allows int8 on the leader ring;
comma-combinable), ``FAABRIC_DELTA_CACHE_MB`` (each side's base-cache
budget, default 128) and ``FAABRIC_WIRE_CODEC_MIN_GIBS`` (the link speed
above which ``auto`` keeps a link raw; default 4).

The governor reads a link's rate from the perf store's big-frame
evidence for the destination host, then from the comm matrix's (src,
dst) cell; an unmeasured link counts as slow. Without the knob set, the
threshold is tuned from the store's measured delta rate times the
link's observed compression ratio. Every verdict change is
flight-recorded (``codec_verdict``) and counted.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import zlib

import numpy as np

from faabric_tpu_torch.telemetry import (
    flight_record,
    get_metrics,
    get_perf_store,
)
from faabric_tpu_torch.util.delta import (
    DeltaSettings,
    apply_delta,
    delta_is_xor_only,
    sampled_overlap_parts,
    serialize_delta_parts,
)
from faabric_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)

# -- wire codec ids (bulk frame header `codec` byte) ---------------------
CODEC_RAW = 0
CODEC_FULL = 1   # raw payload; establishes base `self_epoch`
CODEC_DELTA = 2  # util/delta.py stream vs `base_epoch` → `self_epoch`
CODEC_ZLIB = 3   # whole-payload zlib full frame (low-entropy escape)

# Frame header flag bits
FLAG_CACHE = 1   # receiver stores the decoded payload as `self_epoch`
FLAG_ESCAPE = 2  # full frame sent to heal a NACK / reconnect / force

CODEC_LABELS = {CODEC_RAW: "raw", CODEC_FULL: "delta-full",
                CODEC_DELTA: "delta", CODEC_ZLIB: "zlib"}

# Streams below this never bother with the codec plane: the cache
# bookkeeping costs more than the wire for small frames, and the RPC
# plane carries most of them anyway.
CODEC_MIN_BYTES = 64 * 1024

# Delta encode parameters: page-granular XOR + zlib over the dirty
# command stream — the exact settings the snapshot push proved out.
DELTA_SETTINGS = DeltaSettings(page_size=4096, use_xor=True, zlib_level=1)
# A sampled-page identity fraction below this means "different data,
# not a mutated round" — ship full instead of paying a doomed encode.
OVERLAP_MIN = 0.35
PROBE_PAGES = 8
# A delta bigger than this fraction of the raw payload loses to full.
DELTA_MAX_RATIO = 0.75
# Sampled bits/byte above which zlib full frames never pay.
ZLIB_ENTROPY_MAX = 6.5
# Per-stream bounds: base epochs kept (cyclic chunk pipelines need one
# per chunk position) and the NACK-resend window of recent coded seqs.
MAX_BASES_PER_STREAM = 48
SENT_WINDOW = 16

# Auto-mode bandwidth evidence comes only from size classes at least
# this big: a compact delta frame's wall time is dispatch overhead and
# reads as a falsely slow link, which would lock a fast link into
# compression on its own output. With only small-frame evidence the
# store reports None and the comm matrix's raw-rate fallback decides
GOVERNOR_BW_EVIDENCE_BYTES = 256 * 1024

_metrics = get_metrics()
_CODEC_TX_FRAMES = {
    label: _metrics.counter(
        "faabric_codec_frames_total",
        "Coded bulk frames sent per wire codec", codec=label)
    for label in ("delta", "delta-full", "zlib")
}
_CODEC_SAVED = {
    label: _metrics.counter(
        "faabric_codec_bytes_saved_total",
        "Raw-minus-wire bytes saved per codec", codec=label)
    for label in ("delta", "zlib")
}
_CODEC_ESCAPES = {
    reason: _metrics.counter(
        "faabric_codec_escapes_total",
        "Full-frame escapes by reason", reason=reason)
    for reason in ("nack", "reconnect", "lost_payload", "crc",
                   "base_missing", "decode_error")
}
# Rolling double-buffer base reuse: rounds whose steady-state insert or
# apply copy became an O(dirty) in-place patch of the two-rounds-old
# buffer, and the flatten bytes avoided
_CODEC_BASE_REUSE = {
    side: _metrics.counter(
        "faabric_codec_base_reuse_total",
        "Rolling base-buffer reuses (flatten/apply copy avoided)",
        side=side)
    for side in ("send", "recv")
}
_CODEC_BASE_REUSE_BYTES = {
    side: _metrics.counter(
        "faabric_codec_base_reuse_bytes_total",
        "Payload bytes whose full copy the rolling bases avoided",
        side=side)
    for side in ("send", "recv")
}
_CODEC_VERDICT_FLIPS = _metrics.counter(
    "faabric_codec_verdict_flips_total",
    "Governor per-link codec verdict changes (flight-recorded)")


def count_escape(reason: str) -> None:
    c = _CODEC_ESCAPES.get(reason)
    if c is not None:
        c.inc()


def payload_entropy(arr: np.ndarray, sample: int = 4096) -> float:
    """Sampled byte entropy in bits/byte (0..8). Three strided probes
    instead of one prefix read: parameter buffers often carry a
    low-entropy header before high-entropy weights."""
    n = arr.size
    if n == 0:
        return 0.0
    if n <= sample:
        s = arr
    else:
        step = max(1, sample // 3)
        s = np.concatenate([arr[:step], arr[n // 2:n // 2 + step],
                            arr[n - step:]])
    counts = np.bincount(s, minlength=256)
    p = counts[counts > 0] / s.size
    return float(-(p * np.log2(p)).sum())


def _cache_budget_bytes() -> int:
    try:
        mb = int(os.environ.get("FAABRIC_DELTA_CACHE_MB", "128"))
    except ValueError:
        mb = 128
    return max(0, mb) << 20


def crc_of(buf) -> int:
    return zlib.crc32(buf) & 0xFFFFFFFF


def _flatten(parts: list, total: int) -> np.ndarray:
    """One private contiguous uint8 array from ordered segments."""
    if len(parts) == 1:
        return np.array(parts[0], dtype=np.uint8, copy=True)
    flat = np.empty(total, dtype=np.uint8)
    off = 0
    for p in parts:
        flat[off:off + p.size] = p
        off += p.size
    return flat


class CodedFrame:
    """One encoded frame, ready for the bulk header + wire."""

    __slots__ = ("codec", "flags", "base_epoch", "self_epoch", "crc",
                 "wire", "raw_nbytes")

    def __init__(self, codec: int, flags: int, base_epoch: int,
                 self_epoch: int, crc: int, wire: np.ndarray,
                 raw_nbytes: int) -> None:
        self.codec = codec
        self.flags = flags
        self.base_epoch = base_epoch
        self.self_epoch = self_epoch
        self.crc = crc
        self.wire = wire
        self.raw_nbytes = raw_nbytes


class _SendStream:
    """Sender-side state for one (group, src, dst, channel) stream."""

    __slots__ = ("bases", "order", "sent", "hint", "next_epoch",
                 "force_full", "by_print", "roll", "last_delta", "hist")

    def __init__(self) -> None:
        self.bases: dict[int, np.ndarray] = {}   # epoch → payload copy
        self.order: list[int] = []               # insertion order
        self.sent: dict[int, int] = {}           # recent seq → epoch
        self.hint = 0                            # cyclic base rotation
        self.next_epoch = 1
        self.force_full = False
        # Content fingerprint → epoch (latest wins): O(1) base lookup
        # for sharded streams — a linear candidate scan degrades as
        # mutated shards append fresh epochs and the rotation hint
        # desyncs (measured: per-round cost grew ~25 ms/round at 13
        # shards). A probe still CONFIRMS every hit before use.
        self.by_print: dict[tuple, int] = {}
        # Rolling double-buffer lineage: the last
        # two consecutively-inserted epochs, plus the delta command
        # stream that transformed roll[0]'s content into roll[1]'s.
        # When round r encodes against roll[1], roll[0]'s buffer can be
        # patched in place (last_delta then this round's delta — both
        # O(dirty pages)) to hold round r's content, so the steady
        # state pays NO full flatten copy and NO allocation.
        self.roll: list[int] = []
        self.last_delta: bytes | None = None
        # Delta history for the NACK-heal window: (self_epoch,
        # base_epoch, delta_bytes) per delta insert, SENT_WINDOW deep.
        # Rolling recycles base BUFFERS, but same-size streams emit
        # pure-XOR deltas — which are self-inverting — so a recycled
        # epoch's payload is reconstructible by reverse-applying the
        # chain from any live base (see _reconstruct_locked). The
        # resend guarantee therefore survives the copy elimination.
        self.hist: list[tuple[int, int, bytes]] = []


# Fingerprint sample geometry: a few fixed 16-byte windows spread over
# the frame. A ~1% mutation usually misses every window, so unchanged
# shards hit their base in O(1); a window landing in the mutated slice
# just demotes that shard to the bounded scan.
_PRINT_OFFSETS = (0.13, 0.41, 0.67, 0.89)
_PRINT_BYTES = 16
# Fallback scan depth: cyclic streams should hit via fingerprint or
# hint; an unbounded scan over a mutating stream is O(rounds).
MAX_PROBE_CANDIDATES = 16


def _fingerprint(parts: list, total: int) -> tuple:
    """(total, sampled windows) over the logical frame, segment-aware."""
    samples = []
    bounds = []
    off = 0
    for p in parts:
        bounds.append((off, off + p.size, p))
        off += p.size
    for frac in _PRINT_OFFSETS:
        lo = min(int(total * frac), max(0, total - _PRINT_BYTES))
        hi = min(lo + _PRINT_BYTES, total)
        for s_lo, s_hi, p in bounds:
            if s_lo <= lo and hi <= s_hi:
                samples.append(p[lo - s_lo:hi - s_lo].tobytes())
                break
        else:
            samples.append(b"")  # straddles a segment boundary: skip
    return (total, *samples)


class SenderDeltaCache:
    """Bounded last-sent payload cache + delta encoder for one stripe.

    Sized by ``FAABRIC_DELTA_CACHE_MB``; eviction is global-LRU by
    insertion with per-stream ``MAX_BASES_PER_STREAM``. The NACK-resend
    window keeps the last ``SENT_WINDOW`` coded seqs' epochs alive so a
    receiver-reported undecodable frame can be re-shipped full with the
    SAME sequence number (the ordered-recv path then heals the gap).
    """

    # Concurrency contract (analysis/concheck.py): every structure is
    # mutated under _lock. Callers additionally hold the owning
    # stripe's lock (lock order stripe.lock → _lock, see _Stripe):
    # encode and the NACK-heal resends must serialize against each
    # other so base/delta wire order matches cache order — _lock alone
    # guards the STRUCTURES, the stripe lock guards the PROTOCOL.
    GUARDS = {
        "_streams": "_lock",
        "_bytes": "_lock",
        "_lru": "_lock",
        "reused": "_lock",
        "reused_bytes": "_lock",
        "reconstructed": "_lock",
    }

    def __init__(self, budget_bytes: int | None = None) -> None:
        self._lock = threading.Lock()
        self._streams: dict[tuple, _SendStream] = {}
        # (key, epoch) → None, insertion-ordered: dict instead of list
        # so the per-frame rolled-path removal is O(1), not a scan of
        # every cached base under the lock
        self._lru: dict[tuple, None] = {}
        self._bytes = 0
        # Rolling base-reuse accounting (unit-pinned): rounds that
        # skipped the flatten copy, the payload bytes not copied, and
        # NACK heals served by XOR-chain reconstruction
        self.reused = 0
        self.reused_bytes = 0
        self.reconstructed = 0
        self.budget = (_cache_budget_bytes() if budget_bytes is None
                       else budget_bytes)

    # -- encode ---------------------------------------------------------
    def encode(self, key: tuple, parts: list, seq: int,
               mode: str = "delta") -> CodedFrame:
        """Encode one stream payload, given as ORDERED uint8 segments
        whose concatenation is the logical frame (a bulk frame arrives
        as [small MPI header | big body view] — the steady state must
        not pay a flatten copy). Always returns a frame — DELTA when a
        probed base matches (mode "delta"), FULL/ZLIB otherwise
        (establishing a fresh epoch-tagged base; the flatten copy a
        full frame pays IS the cache entry). Mode "zlib" skips base
        probing entirely."""
        total = sum(p.size for p in parts)
        with self._lock:
            st = self._streams.get(key)
            if st is None:
                st = self._streams[key] = _SendStream()
            if st.force_full:
                st.force_full = False
                return self._full_locked(key, st, parts, total, seq,
                                         True, FLAG_ESCAPE)
            if mode != "delta":
                return self._full_locked(key, st, parts, total, seq,
                                         True, 0)
            fp = _fingerprint(parts, total)
            base_epoch = self._pick_base_locked(st, parts, total, fp)
            if base_epoch == 0:
                return self._full_locked(key, st, parts, total, seq,
                                         True, 0)
            base = st.bases[base_epoch]
            delta = serialize_delta_parts(DELTA_SETTINGS, base, parts)
            if len(delta) >= total * DELTA_MAX_RATIO:
                return self._full_locked(key, st, parts, total, seq,
                                         True, 0)
            wire = np.frombuffer(delta, dtype=np.uint8)
            if len(delta) < 64 and total == base.nbytes:
                # Zero dirty pages: payload IS the base — reuse its
                # epoch, no cache copy, steady-state cost ≈ one memcmp
                self_epoch = base_epoch
            else:
                self_epoch = self._insert_rolled_locked(
                    key, st, parts, total, fp, base_epoch, delta)
            st.sent[seq] = self_epoch
            self._trim_sent_locked(st)
            _CODEC_TX_FRAMES["delta"].inc()
            _CODEC_SAVED["delta"].inc(total - len(delta))
            return CodedFrame(CODEC_DELTA, FLAG_CACHE, base_epoch,
                              self_epoch, crc_of(delta), wire, total)

    def _full_locked(self, key: tuple, st: _SendStream, parts: list,
                     total: int, seq: int, allow_zlib: bool,
                     flags: int) -> CodedFrame:
        flat = _flatten(parts, total)
        epoch = self._insert_locked(key, st, flat,
                                    _fingerprint([flat], total))
        # A full frame starts a fresh lineage (no delta transforms the
        # previous content into this one)
        st.roll = [epoch]
        st.last_delta = None
        st.sent[seq] = epoch
        self._trim_sent_locked(st)
        if allow_zlib and payload_entropy(flat) <= ZLIB_ENTROPY_MAX:
            z = zlib.compress(flat.tobytes(), 1)
            if len(z) < total * DELTA_MAX_RATIO:
                wire = np.frombuffer(z, dtype=np.uint8)
                _CODEC_TX_FRAMES["zlib"].inc()
                _CODEC_SAVED["zlib"].inc(total - len(z))
                return CodedFrame(CODEC_ZLIB, FLAG_CACHE | flags, 0,
                                  epoch, crc_of(z), wire, total)
        _CODEC_TX_FRAMES["delta-full"].inc()
        # The wire buffer IS the cache entry (read-only; the vectored
        # send only reads it) — a full frame costs exactly one copy
        return CodedFrame(CODEC_FULL, FLAG_CACHE | flags, 0, epoch, 0,
                          flat, total)

    def _insert_rolled_locked(self, key: tuple, st: _SendStream,
                              parts: list, total: int, fp: tuple,
                              base_epoch: int, delta: bytes) -> int:
        """Register the new payload as a base. Steady state — the frame
        was encoded against the LATEST base and the lineage's older
        buffer is idle — patches the two-rounds-old buffer in place:
        ``last_delta`` rolls it forward to the latest content, this
        round's delta to the new. Two O(dirty-pages) patches replace the
        O(total) flatten copy AND its allocation, with net-zero cache
        byte accounting. Every other shape (cyclic multi-base streams,
        resized payloads, a buffer still referenced by a NACK resend)
        falls back to the flatten path and restarts the lineage."""
        roll = st.roll
        if (len(roll) == 2 and base_epoch == roll[1]
                and st.last_delta is not None):
            buf = st.bases.get(roll[0])
            # refcount 3 == bases dict + `buf` + getrefcount's argument;
            # anything higher means an in-flight frame or NACK resend
            # still reads the buffer — never patch under a reader
            if (buf is not None and buf.nbytes == total
                    and sys.getrefcount(buf) <= 3):
                old = roll[0]
                try:
                    buf.flags.writeable = True
                    apply_delta(st.last_delta, buf, out=buf)
                    apply_delta(delta, buf, out=buf)
                except Exception:  # noqa: BLE001 — corrupt lineage:
                    # the half-patched buffer is garbage; drop it and
                    # restart the lineage on the flatten path below
                    self._drop_locked(key, st, old)
                    st.roll = []
                    st.last_delta = None
                else:
                    buf.flags.writeable = False
                    epoch = st.next_epoch
                    st.next_epoch += 1
                    # Re-register the same allocation under the new
                    # epoch: bookkeeping moves, byte accounting constant
                    del st.bases[old]
                    try:
                        st.order.remove(old)
                    except ValueError:
                        pass
                    self._lru.pop((key, old), None)
                    for k in [k for k, e in st.by_print.items()
                              if e == old]:
                        del st.by_print[k]
                    st.bases[epoch] = buf
                    st.order.append(epoch)
                    st.by_print[fp] = epoch
                    self._lru[(key, epoch)] = None
                    st.roll = [roll[1], epoch]
                    st.last_delta = bytes(delta)
                    self._hist_append_locked(st, epoch, base_epoch,
                                             st.last_delta)
                    self.reused += 1
                    self.reused_bytes += total
                    _CODEC_BASE_REUSE["send"].inc()
                    _CODEC_BASE_REUSE_BYTES["send"].inc(total)
                    return epoch
        epoch = self._insert_locked(key, st, _flatten(parts, total), fp)
        # Lineage (re)starts here: valid iff the base we encoded
        # against survived the insert's eviction pass
        st.roll = ([base_epoch, epoch] if base_epoch in st.bases
                   else [epoch])
        st.last_delta = bytes(delta)
        self._hist_append_locked(st, epoch, base_epoch, st.last_delta)
        return epoch

    @staticmethod
    def _hist_append_locked(st: _SendStream, self_epoch: int,
                            base_epoch: int, delta: bytes) -> None:
        st.hist.append((self_epoch, base_epoch, delta))
        while len(st.hist) > SENT_WINDOW:
            st.hist.pop(0)

    def _pick_base_locked(self, st: _SendStream, parts: list,
                          total: int, fp: tuple) -> int:
        """Best cached base epoch, or 0. Order of attack: the content
        fingerprint (O(1), unchanged shards), then the cyclic rotation
        hint, then a BOUNDED newest-first scan — every hit is confirmed
        by the sampled-page probe before use."""
        order = st.order
        n = len(order)
        if n == 0:
            return 0
        hit = st.by_print.get(fp)
        if hit is not None:
            base = st.bases.get(hit)
            if base is not None and base.nbytes == total \
                    and sampled_overlap_parts(
                        base, parts, DELTA_SETTINGS.page_size,
                        PROBE_PAGES) >= OVERLAP_MIN:
                return hit
        for probe in range(min(n, MAX_PROBE_CANDIDATES)):
            epoch = order[(st.hint + probe) % n]
            base = st.bases[epoch]
            if base.nbytes != total:
                continue
            frac = sampled_overlap_parts(base, parts,
                                         DELTA_SETTINGS.page_size,
                                         PROBE_PAGES)
            if frac >= OVERLAP_MIN:
                st.hint = (st.hint + probe + 1) % n
                return epoch
        return 0

    def _insert_locked(self, key: tuple, st: _SendStream,
                       flat: np.ndarray, fp: tuple) -> int:
        """``flat`` must be a PRIVATE contiguous uint8 array — it
        becomes the immutable cache entry without another copy."""
        epoch = st.next_epoch
        st.next_epoch += 1
        flat.flags.writeable = False
        st.bases[epoch] = flat
        st.order.append(epoch)
        st.by_print[fp] = epoch  # latest content under this print wins
        self._lru[(key, epoch)] = None
        self._bytes += flat.nbytes
        while len(st.order) > MAX_BASES_PER_STREAM:
            self._drop_locked(key, st, st.order[0])
        self._evict_locked()
        return epoch

    def _drop_locked(self, key: tuple, st: _SendStream,
                     epoch: int) -> None:
        # LRU entry goes first, unconditionally: an entry surviving an
        # early return here would wedge _evict_locked's head-pop loop
        self._lru.pop((key, epoch), None)
        base = st.bases.pop(epoch, None)
        if base is None:
            return
        self._bytes -= base.nbytes
        try:
            st.order.remove(epoch)
        except ValueError:
            pass
        for k in [k for k, e in st.by_print.items() if e == epoch]:
            del st.by_print[k]
        if epoch in st.roll:  # evicted lineage member: lineage is dead
            st.roll = []
            st.last_delta = None

    def _evict_locked(self) -> None:
        while self._bytes > self.budget and self._lru:
            key, epoch = next(iter(self._lru))
            st = self._streams.get(key)
            if st is None:
                self._lru.pop((key, epoch), None)
                continue
            self._drop_locked(key, st, epoch)

    def _trim_sent_locked(self, st: _SendStream) -> None:
        while len(st.sent) > SENT_WINDOW:
            st.sent.pop(next(iter(st.sent)))

    # -- NACK healing ---------------------------------------------------
    def take_for_resend(self, key: tuple, seq: int
                        ) -> tuple[np.ndarray, int] | None:
        """The raw payload + epoch for a NACKed seq (None if the resend
        window no longer covers it — the documented unhealable-gap
        corner, same stance as a bulk RST). An epoch whose BUFFER the
        rolling double-buffer recycled is reconstructed from the
        retained XOR delta chain (pure-XOR deltas are self-inverting),
        so base reuse does not narrow the heal window. Marks the stream
        so its next regular frame ships full, re-establishing a base
        the receiver certainly has."""
        with self._lock:
            st = self._streams.get(key)
            if st is None:
                return None
            st.force_full = True
            epoch = st.sent.get(seq)
            if epoch is None:
                return None
            base = st.bases.get(epoch)
            if base is None:
                return self._reconstruct_locked(st, epoch)
            return base, epoch

    def _reconstruct_locked(self, st: _SendStream, epoch: int
                            ) -> tuple[np.ndarray, int] | None:
        """Rebuild a recycled epoch's payload by reverse-applying the
        delta chain from the newest LIVE base down to ``epoch``: each
        hist entry's delta transformed base→self, and a pure-XOR delta
        applied to the SELF content yields the BASE content back.
        Overwrite commands (frame growth) are not invertible — a chain
        containing one gives up (the pre-existing lost_payload corner).
        O(total) copy + O(chain × dirty) patches, on the rare NACK path
        only."""
        # Walk hist newest-first until we reach the requested epoch,
        # requiring an unbroken base←self lineage
        chain: list[bytes] = []
        need = None  # the self_epoch the next-older entry must provide
        start = None  # the live epoch reconstruction starts from
        for self_e, base_e, delta in reversed(st.hist):
            if need is None:
                if st.bases.get(self_e) is None:
                    continue  # not live: keep looking for an anchor
                need = self_e
                start = self_e
            if self_e != need:
                return None  # lineage gap
            chain.append(delta)
            need = base_e
            if base_e == epoch:
                break
        else:
            return None
        if start is None:
            return None
        buf = st.bases[start].copy()
        try:
            for delta in chain:
                if not delta_is_xor_only(delta):
                    return None
                apply_delta(delta, buf, out=buf)
        except Exception:  # noqa: BLE001 — size drift, corrupt stream
            return None
        buf.flags.writeable = False
        self.reconstructed += 1
        return buf, epoch

    def reset(self) -> None:
        """Forget everything (stripe reconnect: the receiver's per-conn
        cache died with the connection, so every base is stale)."""
        with self._lock:
            self._streams.clear()
            self._lru.clear()  # dict: clears in O(n), no scans after
            self._bytes = 0

    # -- observability --------------------------------------------------
    @property
    def cached_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def stream_count(self) -> int:
        with self._lock:
            return len(self._streams)


class _RecvStream:
    __slots__ = ("bases", "order", "roll", "last_delta")

    def __init__(self) -> None:
        self.bases: dict[int, np.ndarray] = {}
        self.order: list[int] = []
        # Rolling lineage, mirror of the sender's (see _SendStream)
        self.roll: list[int] = []
        self.last_delta: bytes | None = None


class ReceiverDeltaCache:
    """Receiver-side epoch-keyed base cache (one per bulk connection —
    it dies with the conn, which is exactly when the sender resets its
    side). ``decode`` returns the raw payload array, or None when the
    frame cannot be decoded safely (caller NACKs)."""

    GUARDS = {
        "_streams": "_lock",
        "_bytes": "_lock",
        "_lru": "_lock",
    }


    def __init__(self, budget_bytes: int | None = None) -> None:
        self._lock = threading.Lock()
        self._streams: dict[tuple, _RecvStream] = {}
        self._lru: dict[tuple, None] = {}  # (key, epoch), insert order
        self._bytes = 0
        self.budget = (_cache_budget_bytes() if budget_bytes is None
                       else budget_bytes)

    def decode(self, key: tuple, codec: int, flags: int, base_epoch: int,
               self_epoch: int, crc: int, wire: np.ndarray,
               raw_nbytes: int) -> np.ndarray | None:
        """Decoded payload, or None (caller NACKs). Delivery is
        ZERO-COPY: the returned array is (or aliases) the immutable
        cache entry, marked read-only — the MPI layer already treats
        non-writable arrays as shared (copy-on-need), and a reader like
        the broadcast assembly pays nothing."""
        if codec == CODEC_FULL:
            if flags & FLAG_CACHE:
                self._store(key, self_epoch, wire)
            return wire
        if codec == CODEC_ZLIB:
            if crc_of(wire) != crc:
                count_escape("crc")
                return None
            try:
                raw = np.frombuffer(
                    zlib.decompress(wire.tobytes()), dtype=np.uint8)
            except zlib.error:
                count_escape("decode_error")
                return None
            if raw.size != raw_nbytes:
                count_escape("decode_error")
                return None
            if flags & FLAG_CACHE:
                self._store(key, self_epoch, raw)
            return raw
        if codec == CODEC_DELTA:
            if crc_of(wire) != crc:
                count_escape("crc")
                return None
            with self._lock:
                st = self._streams.get(key)
                base = st.bases.get(base_epoch) if st is not None else None
            if base is None:
                count_escape("base_missing")
                return None
            if self_epoch == base_epoch:
                # Identical payload: the cached base IS the message —
                # deliver it read-only, zero copies on either side
                return base
            delta_bytes = wire.tobytes()
            rolled = self._decode_rolled(key, base_epoch, self_epoch,
                                         delta_bytes, raw_nbytes)
            if rolled is not None:
                return rolled
            try:
                out = apply_delta(delta_bytes, base)
            except Exception:  # noqa: BLE001 — any decode blowup → NACK
                count_escape("decode_error")
                return None
            if out.size != raw_nbytes:
                count_escape("decode_error")
                return None
            self._store(key, self_epoch, out, lineage_base=base_epoch,
                        delta=delta_bytes)
            return out
        count_escape("decode_error")
        return None

    def _decode_rolled(self, key: tuple, base_epoch: int, self_epoch: int,
                       delta: bytes, raw_nbytes: int) -> np.ndarray | None:
        """Steady-state delta decode without the per-round apply copy:
        when the frame extends the stream's rolling lineage and the
        two-rounds-old buffer has no outside reader (delivered arrays
        are shared zero-copy with the MPI layer — the refcount check
        proves every consumer dropped its reference), patch that buffer
        in place (two O(dirty) passes) instead of allocating a fresh
        full-size base copy. None → caller takes the allocating path."""
        with self._lock:
            st = self._streams.get(key)
            if (st is None or len(st.roll) != 2
                    or base_epoch != st.roll[1]
                    or st.last_delta is None
                    or self_epoch in st.bases):
                return None
            buf = st.bases.get(st.roll[0])
            # bases dict + `buf` + getrefcount's argument = 3; a live
            # consumer (or the ordered-recv queue) holding the array it
            # was delivered pushes the count higher and vetoes reuse
            if (buf is None or buf.nbytes != raw_nbytes
                    or sys.getrefcount(buf) > 3):
                return None
            old = st.roll[0]
            try:
                # May refuse on a buffer backed by an immutable object
                # (e.g. a frombuffer view of bytes) — that's a veto, not
                # an error; the allocating path below handles the frame
                buf.flags.writeable = True
                apply_delta(st.last_delta, buf, out=buf)
                apply_delta(delta, buf, out=buf)
            except Exception:  # noqa: BLE001 — half-patched buffer is
                # garbage: drop it, kill the lineage, decode normally
                self._drop_locked(key, st, old)
                st.roll = []
                st.last_delta = None
                return None
            buf.flags.writeable = False
            del st.bases[old]
            try:
                st.order.remove(old)
            except ValueError:
                pass
            self._lru.pop((key, old), None)
            st.bases[self_epoch] = buf
            st.order.append(self_epoch)
            self._lru[(key, self_epoch)] = None
            st.roll = [base_epoch, self_epoch]
            st.last_delta = delta
            _CODEC_BASE_REUSE["recv"].inc()
            _CODEC_BASE_REUSE_BYTES["recv"].inc(raw_nbytes)
            return buf

    def _store(self, key: tuple, epoch: int, payload: np.ndarray,
               lineage_base: int | None = None,
               delta: bytes | None = None) -> None:
        """Adopt ``payload`` as the immutable base for ``epoch`` — no
        copy: the caller hands over a buffer it exclusively owns (recv
        buffer, decompress output, apply_delta result) and delivery
        shares it read-only. ``lineage_base``/``delta`` extend the
        rolling lineage when this store resulted from a delta against
        the lineage head (see _decode_rolled)."""
        copy = payload
        try:
            copy.flags.writeable = False
        except ValueError:
            copy = payload.copy()
            copy.flags.writeable = False
        with self._lock:
            st = self._streams.get(key)
            if st is None:
                st = self._streams[key] = _RecvStream()
            if epoch in st.bases:
                return  # duplicate-seq redelivery: identical content
            if (lineage_base is not None and delta is not None
                    and lineage_base in st.bases):
                st.roll = [lineage_base, epoch]
                st.last_delta = delta
            else:
                st.roll = [epoch]
                st.last_delta = None
            st.bases[epoch] = copy
            st.order.append(epoch)
            self._lru[(key, epoch)] = None
            self._bytes += copy.nbytes
            while len(st.order) > MAX_BASES_PER_STREAM:
                self._drop_locked(key, st, st.order[0])
            while self._bytes > self.budget and self._lru:
                k, e = next(iter(self._lru))
                s = self._streams.get(k)
                if s is None:
                    self._lru.pop((k, e), None)
                    continue
                self._drop_locked(k, s, e)

    def _drop_locked(self, key: tuple, st: _RecvStream,
                     epoch: int) -> None:
        # LRU entry first, unconditionally — a surviving entry would
        # wedge the budget-eviction head-pop loop above
        self._lru.pop((key, epoch), None)
        base = st.bases.pop(epoch, None)
        if base is None:
            return
        self._bytes -= base.nbytes
        try:
            st.order.remove(epoch)
        except ValueError:
            pass
        if epoch in st.roll:  # evicted lineage member: lineage is dead
            st.roll = []
            st.last_delta = None

    def drop_bases(self) -> None:
        """Test/ops hook: forget every base (simulates a migration remap
        landing the stream on a receiver with stale epoch state)."""
        with self._lock:
            self._streams.clear()
            self._lru.clear()
            self._bytes = 0


# ---------------------------------------------------------------------------
# Governor
# ---------------------------------------------------------------------------

_VALID_TOKENS = {"auto", "raw", "off", "delta", "zlib", "quant"}


def _parse_mode(spec: str) -> frozenset:
    tokens = {t.strip().lower() for t in spec.split(",") if t.strip()}
    bad = tokens - _VALID_TOKENS
    if bad:
        logger.warning("Ignoring unknown FAABRIC_WIRE_CODEC token(s) %s",
                       sorted(bad))
        tokens -= bad
    if not tokens:
        tokens = {"auto"}
    return frozenset(tokens)


class WireCodecGovernor:
    """Per-link codec selection, deterministic on both ends because the
    verdict rides the bulk frame header (and the NaN-scale sentinel on
    the quant plane) — the receiver decodes what the header says, never
    what it guesses the sender chose.

    Policy (``auto``): shm-capable / same-machine links stay raw —
    a ring memcpy beats any codec. Cross-machine links compress when
    their measured bandwidth — the rolling profile store's big-frame
    evidence first (which persists across restarts), the comm-matrix
    window as fallback — is below
    ``FAABRIC_WIRE_CODEC_MIN_GIBS`` (or unmeasured: a fresh WAN link is
    assumed slow until a measurement says otherwise). Forced tokens
    (``delta``/``zlib``) override locality so tests and benches can
    exercise the codec plane on loopback; ``raw``/``off`` disables it.
    Decisions are cached per (host, link, size-class) and re-evaluated
    every comm-matrix window."""

    # Concurrency contract: the decision cache is read/written from
    # every sending thread; the mode/threshold fields are set once in
    # __init__ (or under _lock by set_mode) and read lock-free as
    # immutable snapshots.
    GUARDS = {
        "_decisions": "_lock",
        "_matrix_cells": "_lock",
        "_matrix_expires": "_lock",
    }

    WINDOW_SECONDS = 5.0

    # Clamp range for the TUNED threshold: measurement glitches must
    # not push the break-even outside physically sensible link speeds
    TUNED_MIN_GIBS = 0.25
    TUNED_MAX_GIBS = 32.0

    def __init__(self, mode: str | None = None) -> None:
        self._lock = threading.Lock()
        if mode is None:
            mode = os.environ.get("FAABRIC_WIRE_CODEC", "auto")
        self.mode = _parse_mode(mode)
        # The auto-mode threshold is tuned from the perf store per
        # destination (_threshold_gibs); the knob is an override, used
        # only when set; 4.0 GiB/s is the no-evidence default
        self.min_gibs_env_set = "FAABRIC_WIRE_CODEC_MIN_GIBS" in os.environ
        try:
            self.min_gibs = float(os.environ.get(
                "FAABRIC_WIRE_CODEC_MIN_GIBS", "4.0"))
        except ValueError:
            self.min_gibs = 4.0
            self.min_gibs_env_set = False
        self._decisions: dict[tuple, tuple[str, float]] = {}
        self._matrix_cells: list[dict] = []
        self._matrix_expires = 0.0

    def set_mode(self, spec: str) -> None:
        """Test/bench hook: replace the mode and drop cached verdicts."""
        with self._lock:
            self.mode = _parse_mode(spec)
            self._decisions.clear()

    # -- bulk-plane (lossless) selection --------------------------------
    def bulk_codec(self, host: str, local: bool, src, dst,
                   nbytes: int) -> str:
        """'delta' | 'zlib' | 'raw' for one bulk frame. ``local`` is the
        shm-capability verdict the BulkClient already computed (aliased
        same-machine peers count — their wire is a ring memcpy)."""
        mode = self.mode
        if "raw" in mode or "off" in mode:
            return "raw"
        if "delta" in mode:
            return "delta"
        if "zlib" in mode:
            return "zlib"
        # auto: locality first, then the measured link
        if local:
            return "raw"
        key = (host, src, dst, int(nbytes).bit_length())
        now = time.monotonic()
        with self._lock:
            hit = self._decisions.get(key)
            if hit is not None and now < hit[1]:
                return hit[0]
        # The perf store's decayed per-host bandwidth first (it
        # survives restarts through FAABRIC_PERF_PROFILE_DIR), big-frame
        # evidence only; the comm-matrix window while it has none
        gibs = get_perf_store().link_gibs(
            host, plane="bulk-tcp",
            min_bytes=GOVERNOR_BW_EVIDENCE_BYTES)
        source = "profile"
        if gibs is None:
            gibs = self._link_gibs(src, dst)
            source = "commmatrix"
        threshold, threshold_src = self._threshold_gibs(host, src, dst)
        choice = "delta" if (gibs is None or gibs < threshold) \
            else "raw"
        with self._lock:
            prev = self._decisions.get(key)
            self._decisions[key] = (choice, now + self.WINDOW_SECONDS)
            if len(self._decisions) > 4096:
                self._decisions.clear()  # cardinality backstop
        if prev is None or prev[0] != choice:
            # Why a link changed codec; bounded by the decisions'
            # cardinality times real changes, so the ring never floods
            if prev is not None:
                _CODEC_VERDICT_FLIPS.inc()
            flight_record("codec_verdict", host=host, src=src, dst=dst,
                          verdict=choice,
                          prev=prev[0] if prev else None,
                          gibs=round(gibs, 3) if gibs is not None
                          else None, source=source,
                          threshold=round(threshold, 3),
                          threshold_src=threshold_src)
        return choice

    def _threshold_gibs(self, host: str, src, dst) -> tuple[float, str]:
        """The raw-vs-compress break-even bandwidth for one link.

        Priority: an EXPLICITLY set ``FAABRIC_WIRE_CODEC_MIN_GIBS``
        always wins (the operator override). Otherwise the threshold is
        TUNED from measurement: compression pays exactly while the raw
        link is slower than the delta path's measured *effective*
        payload rate — the store's delta-codec wire bandwidth toward
        ``host`` × the link's observed raw/wire compression ratio (comm
        matrix ``bytes_raw``/``bytes`` on delta rows; per-(src, dst)
        first, any measured delta link as fallback). No delta evidence
        yet → the 4 GiB/s default, exactly as before."""
        if self.min_gibs_env_set:
            return self.min_gibs, "env"
        delta_gibs = get_perf_store().link_gibs(
            host, plane="bulk-tcp", codec="delta")
        if delta_gibs is None or delta_gibs <= 0:
            return self.min_gibs, "default"
        ratio = self._delta_ratio(src, dst)
        if ratio is None:
            return self.min_gibs, "default"
        tuned = min(max(delta_gibs * ratio, self.TUNED_MIN_GIBS),
                    self.TUNED_MAX_GIBS)
        return tuned, "tuned"

    def _delta_ratio(self, src, dst) -> float | None:
        """Observed raw/wire byte ratio of delta frames — per (src,
        dst) when that link has delta history, the matrix-wide delta
        aggregate otherwise (a fresh link borrows the workload's
        typical compressibility). Reuses the windowed comm-matrix
        snapshot ``_link_gibs`` maintains."""
        self._link_gibs(src, dst)  # refresh the window if due
        with self._lock:
            cells = self._matrix_cells
        link_raw = link_wire = all_raw = all_wire = 0
        for c in cells:
            if c.get("codec") != "delta" or c.get("plane") != "bulk-tcp":
                continue
            wire = c.get("bytes", 0)
            raw = c.get("bytes_raw", wire)
            all_raw += raw
            all_wire += wire
            if c.get("src") == str(src) and c.get("dst") == str(dst):
                link_raw += raw
                link_wire += wire
        if link_wire > 0:
            return link_raw / link_wire
        if all_wire > 0:
            return all_raw / all_wire
        return None

    def _link_gibs(self, src, dst) -> float | None:
        """Measured GiB/s for the (src, dst) bulk link from the comm
        matrix, refreshed once per window."""
        from faabric_tpu_torch.telemetry import get_comm_matrix

        now = time.monotonic()
        with self._lock:
            if now >= self._matrix_expires:
                snap = get_comm_matrix().snapshot() or {}
                self._matrix_cells = snap.get("cells", [])
                self._matrix_expires = now + self.WINDOW_SECONDS
            cells = self._matrix_cells
        best = None
        for c in cells:
            if c.get("plane") != "bulk-tcp":
                continue
            if c.get("src") != str(src) or c.get("dst") != str(dst):
                continue
            lat = c.get("lat_sum") or 0.0
            if lat <= 0:
                continue
            gibs = (c.get("bytes_raw", c.get("bytes", 0)) / lat) / (1 << 30)
            if best is None or gibs > best:
                best = gibs
        return best

    # -- quant (lossy) policy for the MPI leader ring -------------------
    def quant_mode(self, world_knob: str) -> str:
        """The effective allreduce quant mode: the world's knob wins
        (``FAABRIC_ALLREDUCE_QUANT=int8`` quantises every hop);
        otherwise the ``quant`` token allows it link by link."""
        if world_knob:
            return world_knob
        return "int8" if "quant" in self.mode else ""

    def quant_for_link(self, world_knob: str, dst_host: str,
                       local: bool) -> bool:
        """Whether this leader-ring hop quantises. The knob quantises
        every hop. The ``quant`` token in ``auto`` mode skips
        same-machine hops, whose bytes are nearly free; forced modes
        quantise every hop like the knob."""
        if world_knob:
            return True
        if "quant" not in self.mode:
            return False
        if "auto" in self.mode and local:
            return False
        return True


_governor: WireCodecGovernor | None = None
_governor_lock = threading.Lock()


def get_wire_governor() -> WireCodecGovernor:
    global _governor
    if _governor is None:
        with _governor_lock:
            if _governor is None:
                _governor = WireCodecGovernor()
    return _governor


def set_wire_codec(spec: str) -> None:
    """Process-wide override (tests / bench workers)."""
    get_wire_governor().set_mode(spec)


def reset_wire_governor() -> None:
    """Test hook: drop the singleton so the next use re-reads env."""
    global _governor
    with _governor_lock:
        _governor = None
