"""Snapshot delta encoding.

Counterpart of ``faabric_tpu/util/delta.py`` (reference
include/faabric/util/delta.h:10-52, src/util/delta.cpp): a page-granular
compare, an optional XOR with the old image, optional compression, and a
stream of commands. The settings string keeps the reference's shape
(``pages=4096;xor;zlib=1``), with zlib where the reference has zstd. The
stream is byte for byte the JAX package's.

Commands: TOTAL_SIZE, ZLIB_COMPRESSED_COMMANDS, DELTA_OVERWRITE,
DELTA_XOR, END: one byte each, lengths and offsets u64 little-endian.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

CMD_TOTAL_SIZE = 1
CMD_ZLIB_COMMANDS = 2
CMD_DELTA_OVERWRITE = 3
CMD_DELTA_XOR = 4
CMD_END = 5


@dataclasses.dataclass
class DeltaSettings:
    """Parsed from e.g. "pages=4096;xor;zlib=1"."""

    page_size: int = 4096
    use_xor: bool = False
    zlib_level: int = 0

    @classmethod
    def parse(cls, spec: str) -> "DeltaSettings":
        out = cls()
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            if part.startswith("pages="):
                out.page_size = int(part.split("=", 1)[1])
            elif part == "xor":
                out.use_xor = True
            elif part.startswith("zlib="):
                out.zlib_level = int(part.split("=", 1)[1])
        return out


def _dirty_runs(flags: np.ndarray) -> list[tuple[int, int]]:
    """Consecutive dirty pages coalesced into (first_page, n_pages)."""
    idx = np.where(flags)[0]
    if idx.size == 0:
        return []
    breaks = np.where(np.diff(idx) > 1)[0]
    starts = np.concatenate([[idx[0]], idx[breaks + 1]])
    ends = np.concatenate([idx[breaks], [idx[-1]]])
    return [(int(s), int(e - s + 1)) for s, e in zip(starts, ends)]


def sampled_overlap(old: "bytes | np.ndarray", new: "bytes | np.ndarray",
                    page_size: int = 4096, samples: int = 8) -> float:
    """Sampled XOR-density probe: the fraction of ``samples``
    evenly-spaced pages that are byte-identical between ``old`` and
    ``new``. O(samples · page_size) — the cheap pre-check the wire
    delta codec runs before committing to a full page scan, so a
    same-shape-but-unrelated payload costs a few memcmps instead of a
    doomed encode. Size-mismatched buffers report 0.0 (a resized
    payload is a different stream generation, not a mutated round)."""
    old_arr = (old.reshape(-1).view(np.uint8) if isinstance(old, np.ndarray)
               else np.frombuffer(old, dtype=np.uint8))
    new_arr = (new.reshape(-1).view(np.uint8) if isinstance(new, np.ndarray)
               else np.frombuffer(new, dtype=np.uint8))
    if old_arr.size != new_arr.size or new_arr.size == 0:
        return 0.0
    n_pages = (new_arr.size + page_size - 1) // page_size
    idx = np.unique(np.linspace(0, n_pages - 1,
                                min(samples, n_pages)).astype(np.int64))
    hits = 0
    for p in idx:
        lo = int(p) * page_size
        hi = min(lo + page_size, new_arr.size)
        if np.array_equal(old_arr[lo:hi], new_arr[lo:hi]):
            hits += 1
    return hits / idx.size


def sampled_overlap_parts(old: "bytes | np.ndarray", parts: list,
                          page_size: int = 4096,
                          samples: int = 8) -> float:
    """``sampled_overlap`` over a SEGMENTED candidate payload (ordered
    buffers whose concatenation is the logical frame) — no flatten
    copy. Sampled pages that straddle a segment boundary are skipped;
    a size mismatch reports 0.0."""
    old_arr = (old.reshape(-1).view(np.uint8) if isinstance(old, np.ndarray)
               else np.frombuffer(old, dtype=np.uint8))
    arrs = [(p.reshape(-1).view(np.uint8) if isinstance(p, np.ndarray)
             else np.frombuffer(p, dtype=np.uint8)) for p in parts]
    total = sum(a.size for a in arrs)
    if total != old_arr.size or total == 0:
        return 0.0
    bounds = []
    off = 0
    for a in arrs:
        bounds.append((off, off + a.size, a))
        off += a.size
    n_pages = (total + page_size - 1) // page_size
    idx = np.unique(np.linspace(0, n_pages - 1,
                                min(samples, n_pages)).astype(np.int64))
    hits = tried = 0
    for pg in idx:
        lo = int(pg) * page_size
        hi = min(lo + page_size, total)
        for s_lo, s_hi, a in bounds:
            if s_lo <= lo and hi <= s_hi:
                tried += 1
                if np.array_equal(a[lo - s_lo:hi - s_lo],
                                  old_arr[lo:hi]):
                    hits += 1
                break
    return hits / tried if tried else 0.0


def _append_delta_body(settings: DeltaSettings, old_arr: np.ndarray,
                       new_arr: np.ndarray, frame_off: int,
                       body: bytearray) -> None:
    """Append DELTA_XOR/OVERWRITE commands for ``new_arr`` vs
    ``old_arr``, with every command offset shifted by ``frame_off``
    (segmented encoding: the segment lives at that offset of the
    logical frame)."""
    ps = settings.page_size
    n = new_arr.size
    from faabric_tpu_torch.util.dirty import page_flags

    for first_page, n_pages in _dirty_runs(page_flags(old_arr, new_arr,
                                                      ps)):
        off = first_page * ps
        end = min((first_page + n_pages) * ps, n)
        # XOR needs old coverage; split a run at the old-size boundary
        xor_end = min(end, old_arr.size) if settings.use_xor else off
        if settings.use_xor and xor_end > off:
            payload = np.bitwise_xor(new_arr[off:xor_end],
                                     old_arr[off:xor_end]).tobytes()
            body += struct.pack("<BQQ", CMD_DELTA_XOR, frame_off + off,
                                len(payload))
            body += payload
            off = xor_end
        if off < end:
            payload = new_arr[off:end].tobytes()
            body += struct.pack("<BQQ", CMD_DELTA_OVERWRITE,
                                frame_off + off, len(payload))
            body += payload


def _finish_delta(settings: DeltaSettings, total: int,
                  body: bytearray) -> bytes:
    body += struct.pack("<B", CMD_END)
    out = bytearray()
    out += struct.pack("<BQ", CMD_TOTAL_SIZE, total)
    use_zlib = settings.zlib_level > 0
    if use_zlib and len(body) > (1 << 16):
        # Compressibility probe: a large command body of structured
        # XOR noise (float mantissa churn) costs zlib more time than it
        # saves on the wire — a loss against any link the delta itself
        # already beat. Sample 4 KiB and compress only when the body
        # is GENUINELY sparse (<~58% of raw), i.e. when zlib pays for
        # itself even on a fast link. The stream stays self-describing
        # (no ZLIB_COMMANDS marker → raw body).
        probe = zlib.compress(bytes(body[:4096]), settings.zlib_level)
        if len(probe) > 2400:
            use_zlib = False
    if use_zlib:
        compressed = zlib.compress(bytes(body), settings.zlib_level)
        out += struct.pack("<BQ", CMD_ZLIB_COMMANDS, len(compressed))
        out += compressed
    else:
        out += body
    return bytes(out)


def _as_u8(buf) -> np.ndarray:
    return (buf.reshape(-1).view(np.uint8) if isinstance(buf, np.ndarray)
            else np.frombuffer(buf, dtype=np.uint8))


def serialize_delta(settings: DeltaSettings, old: "bytes | np.ndarray",
                    new: "bytes | np.ndarray") -> bytes:
    """Encode new relative to old (arrays skip the bytes-conversion
    copy). The dirty scan is one native/vectorized pass and consecutive
    dirty pages emit as single runs, so sparse deltas over big images
    cost ~a memcmp, not a Python loop."""
    old_arr, new_arr = _as_u8(old), _as_u8(new)
    body = bytearray()
    _append_delta_body(settings, old_arr, new_arr, 0, body)
    return _finish_delta(settings, new_arr.size, body)


def serialize_delta_parts(settings: DeltaSettings,
                          old: "bytes | np.ndarray",
                          parts: list) -> bytes:
    """Encode a SEGMENTED new payload (``parts``: ordered buffers whose
    concatenation is the logical frame) against a flat base WITHOUT
    materializing the concatenation — the wire delta codec's hot path,
    where a frame arrives as [small header | big body view] and the
    steady state must cost a memcmp, not a 100 MiB flatten copy. Each
    part compares against its base slice (page-granular within the
    part); command offsets are frame offsets, so ``apply_delta`` needs
    no segment awareness. Parts past the base's end emit as overwrites
    (frame growth)."""
    old_arr = _as_u8(old)
    body = bytearray()
    off = 0
    for part in parts:
        p = _as_u8(part)
        if p.size == 0:
            continue
        if off + p.size <= old_arr.size:
            _append_delta_body(settings, old_arr[off:off + p.size], p,
                               off, body)
        else:
            covered = max(0, old_arr.size - off)
            if covered:
                _append_delta_body(settings, old_arr[off:], p[:covered],
                                   off, body)
            payload = p[covered:].tobytes()
            body += struct.pack("<BQQ", CMD_DELTA_OVERWRITE,
                                off + covered, len(payload))
            body += payload
        off += p.size
    return _finish_delta(settings, off, body)


def delta_is_xor_only(delta: bytes) -> bool:
    """True iff every payload command in the stream is DELTA_XOR — the
    self-inverting form (``apply_delta`` of the same stream onto the
    NEW image yields the OLD one back), which the wire codec's
    NACK-heal reconstruction relies on. An OVERWRITE destroys the old
    bytes and is not invertible. Lives next to the encoder so a format
    change cannot drift past it unnoticed."""
    try:
        cmd, _total = struct.unpack_from("<BQ", delta, 0)
        if cmd != CMD_TOTAL_SIZE:
            return False
        pos = struct.calcsize("<BQ")
        if delta[pos] == CMD_ZLIB_COMMANDS:
            _, comp_len = struct.unpack_from("<BQ", delta, pos)
            off = pos + struct.calcsize("<BQ")
            body = zlib.decompress(delta[off:off + comp_len])
        else:
            body = delta[pos:]
        pos = 0
        while True:
            cmd = body[pos]
            if cmd == CMD_END:
                return True
            if cmd != CMD_DELTA_XOR:
                return False
            _, _off, length = struct.unpack_from("<BQQ", body, pos)
            pos += struct.calcsize("<BQQ") + length
    except (IndexError, struct.error, zlib.error):
        return False


def apply_delta(delta: bytes, old: "bytes | np.ndarray",
                out: "np.ndarray | None" = None) -> np.ndarray:
    """Reconstruct new from old + delta, returning a uint8 array.

    Cost model (reference src/util/delta.cpp applyDelta writes straight
    into the destination buffer; this matches it):
      - default: ONE pass to build the base image (empty + copy of old,
        zero-fill only for growth), then O(delta) patching — no trailing
        ``tobytes`` copy.
      - ``out=`` a preallocated uint8 array of the right size: the base
        copy lands there (steady-state memcpy, no allocation/page-fault
        cost on the hot freeze/thaw path).
      - ``out`` aliasing ``old`` (patch the resident image in place):
        the base copy is skipped entirely — apply is O(delta).
    """
    pos = 0
    cmd, total = struct.unpack_from("<BQ", delta, pos)
    if cmd != CMD_TOTAL_SIZE:
        raise ValueError("Delta stream must start with TOTAL_SIZE")
    pos += struct.calcsize("<BQ")

    cmd = delta[pos]
    if cmd == CMD_ZLIB_COMMANDS:
        (_, comp_len) = struct.unpack_from("<BQ", delta, pos)
        pos += struct.calcsize("<BQ")
        body = zlib.decompress(delta[pos:pos + comp_len])
    else:
        body = delta[pos:]

    old_arr = (old.reshape(-1).view(np.uint8) if isinstance(old, np.ndarray)
               else np.frombuffer(old, dtype=np.uint8))
    common = min(total, old_arr.size)
    if out is None:
        out = np.empty(total, dtype=np.uint8)
        out[:common] = old_arr[:common]
        if total > common:
            out[common:] = 0
    else:
        out = out.reshape(-1).view(np.uint8)
        if out.size != total:
            raise ValueError(
                f"out buffer is {out.size} bytes, delta target is {total}")
        if np.shares_memory(out, old_arr):
            # In-place patch: out already IS the old image (XOR payloads
            # are new^old at their offsets, so patching over old content
            # is exactly right; overwrites don't read it at all)
            if total > common:
                out[common:] = 0
        else:
            out[:common] = old_arr[:common]
            if total > common:
                out[common:] = 0

    pos = 0
    while True:
        cmd = body[pos]
        if cmd == CMD_END:
            break
        _, off, length = struct.unpack_from("<BQQ", body, pos)
        pos += struct.calcsize("<BQQ")
        payload = np.frombuffer(body[pos:pos + length], dtype=np.uint8)
        pos += length
        if cmd == CMD_DELTA_OVERWRITE:
            out[off:off + length] = payload
        elif cmd == CMD_DELTA_XOR:
            np.bitwise_xor(out[off:off + length], payload,
                           out=out[off:off + length])
        else:
            raise ValueError(f"Unknown delta command {cmd}")
    return out
