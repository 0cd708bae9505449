"""Execution graphs.

Counterpart of ``faabric_tpu/util/exec_graph.py`` (reference
include/faabric/util/ExecGraph.h:19-48, src/util/ExecGraph.cpp): call
trees rebuilt from the chained message ids recorded on the planner's
results, with each node's timing as the executor attached it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from faabric_tpu_torch.proto import Message


@dataclasses.dataclass
class ExecGraphNode:
    msg: Message
    children: list["ExecGraphNode"] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ExecGraph:
    root: ExecGraphNode

    def count_nodes(self) -> int:
        def _count(node: ExecGraphNode) -> int:
            return 1 + sum(_count(c) for c in node.children)

        return _count(self.root)

    def to_dict(self) -> dict[str, Any]:
        def _node(n: ExecGraphNode) -> dict[str, Any]:
            return {"msg": n.msg.to_dict(),
                    "timing": node_timing(n.msg),
                    "chained": [_node(c) for c in n.children]}

        return {"root": _node(self.root)}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())


def node_timing(msg: Message) -> dict[str, float]:
    """A node's durations in milliseconds, from the timing the executor
    attaches to each result (``executor.py::_run_task``): ``queue_ms``
    the task's wait for its pool thread, ``exec_ms`` the guest's run,
    ``wall_ms`` message creation to finish."""
    out: dict[str, float] = {}
    details = msg.int_exec_graph_details
    if "queue_us" in details:
        out["queue_ms"] = round(details["queue_us"] / 1000.0, 3)
    if "exec_us" in details:
        out["exec_ms"] = round(details["exec_us"] / 1000.0, 3)
    if msg.timestamp and msg.finish_timestamp:
        out["wall_ms"] = round(
            max(0.0, msg.finish_timestamp - msg.timestamp) * 1000.0, 3)
    return out


def log_chained_function(parent: Message, chained_msg_id: int) -> None:
    """Record a chained call on its parent (reference ExecGraph.h:46)."""
    if chained_msg_id not in parent.chained_msg_ids:
        parent.chained_msg_ids.append(chained_msg_id)


def get_chained_functions(msg: Message) -> list[int]:
    return list(msg.chained_msg_ids)


def build_exec_graph(get_result, root_msg_id: int, app_id: int) -> ExecGraph:
    """Follow the chained ids from ``root_msg_id``; ``get_result(app_id,
    msg_id)`` returns a result ``Message`` (the planner's
    ``get_message_result`` does)."""

    def _build(msg_id: int) -> ExecGraphNode:
        msg = get_result(app_id, msg_id)
        node = ExecGraphNode(msg=msg)
        for child_id in msg.chained_msg_ids:
            node.children.append(_build(child_id))
        return node

    return ExecGraph(root=_build(root_msg_id))
