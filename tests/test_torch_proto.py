"""The port's message schema and wire codecs against the JAX package's.

Messages and batches with every field drawn from a seed are built in
both packages from the same values. The port must encode them to the
same bytes as the reference (JSON form, wire header and binary tail,
pipelined batches, and the transport frame around them), and each
package must decode the other's bytes to equal objects.
"""

import dataclasses
import json
import socket

import numpy as np
import pytest

import faabric_tpu.proto as ref
import faabric_tpu.transport.message as ref_msg
import faabric_tpu_torch.proto as port
import faabric_tpu_torch.transport.message as port_msg

SEEDS = range(6)


def message_fields(rng: np.random.RandomState) -> dict:
    def text(n):
        return "".join(rng.choice(list("abcxyz/_-09é"), size=n))

    def blob():
        return rng.bytes(int(rng.randint(0, 300)))

    return {
        "id": int(rng.randint(1, 2**62)),
        "app_id": int(rng.randint(1, 2**62)),
        "app_idx": int(rng.randint(0, 64)),
        "main_host": text(8),
        "type": int(rng.randint(0, 4)),
        "user": text(5),
        "function": text(7),
        "input_data": blob(),
        "output_data": blob(),
        "timestamp": float(rng.rand() * 1e9),
        "executed_host": text(6),
        "finish_timestamp": float(rng.rand() * 1e9),
        "return_value": int(rng.choice([0, 1, -98, -99])),
        "snapshot_key": text(4),
        "group_id": int(rng.randint(0, 2**62)),
        "group_idx": int(rng.randint(0, 64)),
        "group_size": int(rng.randint(0, 64)),
        "is_mpi": bool(rng.rand() < 0.5),
        "mpi_world_id": int(rng.randint(0, 2**31)),
        "mpi_rank": int(rng.randint(0, 64)),
        "mpi_world_size": int(rng.randint(0, 64)),
        "is_omp": bool(rng.rand() < 0.5),
        "omp_num_threads": int(rng.randint(0, 64)),
        "record_exec_graph": bool(rng.rand() < 0.5),
        "exec_graph_details": {text(3): text(4) for _ in range(2)},
        "int_exec_graph_details": {text(3): int(rng.randint(0, 1000))},
        "chained_msg_ids": [int(v) for v in rng.randint(0, 2**40, 3)],
        "is_migration": bool(rng.rand() < 0.5),
        "lc": {text(4): int(rng.randint(0, 2**50)) for _ in range(2)},
    }


def ber_fields(rng: np.random.RandomState) -> dict:
    return {
        "app_id": int(rng.randint(1, 2**62)),
        "group_id": int(rng.randint(0, 2**62)),
        "user": "u" + str(rng.randint(100)),
        "function": "f" + str(rng.randint(100)),
        "type": int(rng.randint(0, 4)),
        "subtype": int(rng.randint(0, 5)),
        "single_host_hint": bool(rng.rand() < 0.5),
        "single_host": bool(rng.rand() < 0.5),
        "elastic_scale_hint": bool(rng.rand() < 0.5),
        "snapshot_key": "k" + str(rng.randint(100)),
        "evicted_host": "h" + str(rng.randint(100)),
    }


def build(mod, seed, n_msgs=3):
    rng = np.random.RandomState(seed)
    fields = ber_fields(rng)
    msgs = [message_fields(rng) for _ in range(n_msgs)]
    req = mod.BatchExecuteRequest(**fields)
    req.messages = [mod.Message(**m) for m in msgs]
    return req


def as_plain(obj):
    return dataclasses.asdict(obj)


def wire_bytes(header, tail) -> bytes:
    return json.dumps(header).encode() + tail


@pytest.mark.parametrize("seed", SEEDS)
def test_messages_encode_to_the_same_bytes(seed):
    r, p = build(ref, seed), build(port, seed)
    ref_dicts, ref_tail = ref.messages_to_wire(r.messages)
    port_dicts, port_tail = port.messages_to_wire(p.messages)
    assert wire_bytes(port_dicts, port_tail) == wire_bytes(ref_dicts,
                                                           ref_tail)
    for rm, pm in zip(r.messages, p.messages):
        assert port.message_to_json(pm) == ref.message_to_json(rm)


@pytest.mark.parametrize("seed", SEEDS)
def test_batches_encode_to_the_same_bytes(seed):
    r, p = build(ref, seed), build(port, seed)
    assert wire_bytes(*port.ber_to_wire(p)) == wire_bytes(*ref.ber_to_wire(r))
    assert (json.dumps(port.BatchExecuteRequest.to_dict(p))
            == json.dumps(ref.BatchExecuteRequest.to_dict(r)))
    rs = [build(ref, seed * 10 + i, n_msgs=i) for i in range(3)]
    ps = [build(port, seed * 10 + i, n_msgs=i) for i in range(3)]
    assert wire_bytes(*port.bers_to_wire(ps)) == wire_bytes(
        *ref.bers_to_wire(rs))


@pytest.mark.parametrize("seed", SEEDS)
def test_each_package_decodes_the_others_bytes(seed):
    r, p = build(ref, seed), build(port, seed)
    dicts, tail = ref.messages_to_wire(r.messages)
    assert [as_plain(m) for m in port.messages_from_wire(dicts, tail)] == [
        as_plain(m) for m in p.messages]
    dicts, tail = port.messages_to_wire(p.messages)
    assert [as_plain(m) for m in ref.messages_from_wire(dicts, tail)] == [
        as_plain(m) for m in r.messages]

    header, tail = ref.ber_to_wire(r)
    assert as_plain(port.ber_from_wire(json.loads(json.dumps(header)),
                                       tail)) == as_plain(p)
    header, tail = port.ber_to_wire(p)
    assert as_plain(ref.ber_from_wire(json.loads(json.dumps(header)),
                                      tail)) == as_plain(r)

    rs = [build(ref, seed * 10 + i, n_msgs=i) for i in range(3)]
    ps = [build(port, seed * 10 + i, n_msgs=i) for i in range(3)]
    header, tail = ref.bers_to_wire(rs)
    assert [as_plain(b) for b in port.bers_from_wire(header, tail)] == [
        as_plain(b) for b in ps]
    header, tail = port.bers_to_wire(ps)
    assert [as_plain(b) for b in ref.bers_from_wire(header, tail)] == [
        as_plain(b) for b in rs]

    for rm, pm in zip(r.messages, p.messages):
        assert as_plain(port.message_from_json(ref.message_to_json(rm))) \
            == as_plain(pm)
        assert as_plain(ref.message_from_json(port.message_to_json(pm))) \
            == as_plain(rm)


@pytest.mark.parametrize("seed", SEEDS)
def test_transport_frames_are_the_same_bytes(seed):
    """The framed RPC message around a batch: same bytes on the socket,
    and each package reads the other's frame."""
    def frame(mod_msg, mod, req):
        header, tail = mod.ber_to_wire(req)
        a, b = socket.socketpair()
        try:
            mod_msg.send_frame(a, mod_msg.TransportMessage(
                code=10, header={"ber": header}, payload=tail, seqnum=seed))
            a.shutdown(socket.SHUT_WR)
            chunks = []
            while chunk := b.recv(1 << 16):
                chunks.append(chunk)
            return b"".join(chunks)
        finally:
            a.close()
            b.close()

    r, p = build(ref, seed), build(port, seed)
    raw = frame(port_msg, port, p)
    assert raw == frame(ref_msg, ref, r)
    a, b = socket.socketpair()
    try:
        a.sendall(raw)
        got = ref_msg.recv_frame(b)
        a.sendall(raw)
        got_port = port_msg.recv_frame(b)
    finally:
        a.close()
        b.close()
    assert got.seqnum == got_port.seqnum == seed
    assert as_plain(ref.ber_from_wire(got.header["ber"], got.payload)) \
        == as_plain(r)
    assert as_plain(port.ber_from_wire(got_port.header["ber"],
                                       got_port.payload)) == as_plain(p)


def test_status_and_mappings_round_trip_between_packages():
    rng = np.random.RandomState(7)
    st = {"app_id": 5, "finished": True, "expected_num_messages": 2}
    r = ref.BatchExecuteRequestStatus(**st, message_results=[
        ref.Message(**message_fields(rng))])
    rng = np.random.RandomState(7)
    p = port.BatchExecuteRequestStatus(**st, message_results=[
        port.Message(**message_fields(rng))])
    assert json.dumps(p.to_dict()) == json.dumps(r.to_dict())
    assert as_plain(port.BatchExecuteRequestStatus.from_dict(r.to_dict())) \
        == as_plain(p)
    maps = {"app_id": 3, "group_id": 4}
    entry = {"host": "h", "message_id": 9, "app_idx": 1, "group_idx": 2,
             "mpi_port": 8021, "device_ids": [3]}
    rm = ref.PointToPointMappings(**maps, mappings=[
        ref.PointToPointMapping(**entry)])
    pm = port.PointToPointMappings(**maps, mappings=[
        port.PointToPointMapping(**entry)])
    assert json.dumps(pm.to_dict()) == json.dumps(rm.to_dict())
    assert as_plain(port.PointToPointMappings.from_dict(rm.to_dict())) \
        == as_plain(pm)


def test_wire_rejects_tails_that_do_not_fit():
    p = build(port, 0)
    dicts, tail = port.messages_to_wire(p.messages)
    with pytest.raises(ValueError, match="trailing"):
        port.messages_from_wire(dicts, tail + b"x")
    with pytest.raises(ValueError, match="do not fit"):
        port.messages_from_wire(dicts, tail[:-1])
    header, tail = port.bers_to_wire([p])
    with pytest.raises(ValueError, match="declare"):
        port.bers_from_wire(header, tail + b"x")
