"""Render a request trace as a text waterfall, and attribute its stages.

Input is the JSON ``GET /admin/trace/{id}`` returns (or the ``tree`` object
inside it).  One row per span (indent = tree depth) with its start offset, duration,
status and a proportional bar, then the stage attribution over the root's
direct children: the per-stage numbers the bench's ``trace_path`` and
``serverpath`` sections aggregate into percentiles.  The port's copy of the
JAX package's ``tools/tracedump.py``: the same rows, the same attribution
(``stage_attribution``, ``render``), standard library only.
"""

from __future__ import annotations

BAR_WIDTH = 30

# Decision points and nested stages surfaced in the attribution even when
# they are not direct children of the root.  They overlap the
# admission/queue/device/respond chain (the ingest ones ride inside
# admission's window, batch_form inside queue's, serialize inside
# respond's, the acceptor fast lane's inside admission's), so they are
# attribution rows, never part of stage coverage.
SUBSTAGES = ("variant_select", "adapter_gather", "adapter_attach",
             "prefix_hit", "prefix_insert", "prefill_chunk",
             "spec_draft", "spec_verify", "cold_start", "adapter_cold",
             "load_shed", "retry", "migrate_export", "migrate_import",
             "kv_failover",
             "payload_read", "json_decode", "b64_decode", "validate",
             "batch_form", "serialize",
             "binary_decode", "sock_read", "frame_validate", "ring_wait")

_ATTRS = ("batch_size", "batch_mates", "attempt", "lane", "tokens", "error", "shed",
          "variant", "adapter", "slot", "waited_ms", "cached_tokens", "cow_copies",
          "prefix_cached", "chunk", "degraded", "bytes", "instances")


def _tree_of(payload: dict) -> dict:
    """The /admin/trace/{id} envelope, the trace dict, or a bare tree."""
    if "trace" in payload and isinstance(payload["trace"], dict):
        payload = payload["trace"]
    return payload


def _walk(node: dict, depth: int = 0):
    yield depth, node
    for child in node.get("children", []):
        yield from _walk(child, depth + 1)


def stage_attribution(payload: dict) -> dict:
    """Per-stage durations from the root's direct children:
    ``{"total_ms", "stages": {name: ms}, "substages"?, "coverage_pct"}``.
    Coverage is how much of the root's wall the stage chain tiles; repeated
    stages (retried device attempts, chunk slices) sum; substages
    (:data:`SUBSTAGES`, anywhere in the tree) are counted and summed apart."""
    trace = _tree_of(payload)
    root = trace.get("tree", trace)
    total = float(root.get("duration_ms", 0.0))
    stages: dict[str, float] = {}
    for child in root.get("children", []):
        if child["name"] in SUBSTAGES:
            continue
        stages[child["name"]] = stages.get(child["name"], 0.0) + float(
            child.get("duration_ms", 0.0))
    covered = sum(stages.values())
    substages: dict[str, dict] = {}
    for _, node in _walk(root):
        if node is root or node["name"] not in SUBSTAGES:
            continue
        s = substages.setdefault(node["name"], {"count": 0, "ms": 0.0})
        s["count"] += 1
        s["ms"] = round(s["ms"] + float(node.get("duration_ms", 0.0)), 3)
    return {"total_ms": round(total, 3),
            "stages": {k: round(v, 3) for k, v in stages.items()},
            **({"substages": substages} if substages else {}),
            "coverage_pct": round(100.0 * covered / total, 1) if total else None}


def render(payload: dict, bar_width: int = BAR_WIDTH) -> str:
    """The waterfall text of one trace."""
    trace = _tree_of(payload)
    root = trace.get("tree", trace)
    total = max(float(root.get("duration_ms", 0.0)), 1e-9)
    head = (f"{trace.get('name', root.get('name', '?'))} {trace.get('model') or ''} trace "
            f"{trace.get('trace_id', '?')} ({trace.get('status', root.get('status', '?'))}, "
            f"{total:.1f} ms)")
    lines = [" ".join(head.split())]
    rows = list(_walk(root))
    name_w = max(len("  " * d + n["name"]) for d, n in rows) + 2
    for depth, node in rows:
        start = float(node.get("start_ms", 0.0))
        dur = float(node.get("duration_ms", 0.0))
        lead = min(int(bar_width * max(start, 0.0) / total), bar_width)
        fill = min(max(int(bar_width * dur / total), 1 if dur > 0 else 0), bar_width - lead)
        bar = " " * lead + "#" * fill + " " * (bar_width - lead - fill)
        mark = "!" if node.get("status") == "error" else " "
        name = ("  " * depth + node["name"]).ljust(name_w)
        attrs = node.get("attrs") or {}
        keys = [k for k in _ATTRS if k in attrs]
        extra = ("  " + " ".join(f"{k}={attrs[k]}" for k in keys)) if keys else ""
        lines.append(f"{start:9.1f}ms {mark}{dur:9.1f}ms  {name}[{bar}]{extra}")
    att = stage_attribution(payload)
    if att["stages"]:
        parts = [f"{k}={v:.1f}ms ({100 * v / max(att['total_ms'], 1e-9):.0f}%)"
                 for k, v in att["stages"].items()]
        lines.append("stages: " + "  ".join(parts)
                     + (f"  coverage={att['coverage_pct']:.1f}%"
                        if att["coverage_pct"] is not None else ""))
    if att.get("substages"):
        lines.append("substages: " + "  ".join(
            f"{k}={v['ms']:.1f}ms x{v['count']}" for k, v in att["substages"].items()))
    return "\n".join(lines)

