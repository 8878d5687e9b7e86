"""Command line of the PyTorch/CUDA port.

- ``serve``  run the HTTP serving stack::

      python -m pytorch_zappa_serverless_tpu_torch.cli serve \\
          --config profile.yaml --platform cuda

  ``--platform`` defaults to ``cuda``; without a GPU the command fails
  unless ``--platform cpu`` asks for the CPU.  With ``drain_timeout_s > 0``
  in the profile, SIGTERM drains gracefully (``/healthz`` and new work 503,
  in-flight work given the budget) before the server stops; a second
  SIGTERM skips the drain.
- ``list-models``  print the registered model zoo.
- ``models``, ``adapters``, ``prefix``, ``slo``, ``autoscale``  HTTP clients
  of a running server's ``/admin/models``, ``/admin/adapters``,
  ``/admin/prefix``, ``/admin/slo`` and ``/admin/autoscale``: each prints
  its table (``--json`` the raw body)::

      python -m pytorch_zappa_serverless_tpu_torch.cli slo --url http://127.0.0.1:8000
"""

from __future__ import annotations

import argparse
import json
import sys

from .config import load_config


def cmd_serve(args) -> int:
    from .serving.server import run

    cfg = load_config(args.config, args.profile)
    if args.port is not None:
        cfg.port = args.port
    if args.host:
        cfg.host = args.host
    run(cfg, device=args.platform)
    return 0


def cmd_list_models(args) -> int:
    from . import models as _zoo  # noqa: F401  (populates the registry)
    from .utils.registry import list_models

    for name in list_models():
        print(name)
    return 0


def format_models_table(payload: dict) -> str:
    """Render the ``GET /admin/models`` snapshot as the ``models`` table:
    residency state, tier, pin, HBM, LRU age, grouped by variant family,
    quality-descending, so each family's degradation ladder reads
    top-to-bottom."""
    cols = ("FAMILY", "Q", "MODEL", "STATE", "TIER", "PIN", "HBM_MB",
            "HOST_MB", "DISK_MB", "LAST_USED_S", "ACTIVATIONS", "EST_WARM_MS")
    rows = [cols]
    models = payload.get("models", {})
    order = sorted(models,
                   key=lambda n: (models[n].get("family") or n,
                                  -(models[n].get("quality_rank") or 0), n))
    for name in order:
        m = models[name]
        rows.append((
            m.get("family") or name,
            str(m.get("quality_rank", 0)),
            name,
            ("pinned" if m.get("pinned") else m.get("state", "?")),
            m.get("tier", "?"),
            "yes" if m.get("pinned") else "-",
            f"{(m.get('hbm_bytes') or 0) / (1024 * 1024):.1f}",
            f"{(m.get('host_bytes') or 0) / (1024 * 1024):.1f}",
            f"{(m.get('disk_bytes') or 0) / (1024 * 1024):.1f}",
            f"{m.get('last_used_s_ago', 0):.1f}",
            str(m.get("activations", 0)),
            f"{m.get('estimated_warm_ms', 0):.0f}",
        ))
    widths = [max(len(r[i]) for r in rows) for i in range(len(cols))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
             for r in rows]
    store = payload.get("ckpt_store")
    if store:
        lines.append(
            f"ckpt store: {store.get('manifests', 0)} manifests, "
            f"{(store.get('physical_bytes') or 0) / (1024 * 1024):.1f} MB on"
            f" disk ({(store.get('logical_bytes') or 0) / (1024 * 1024):.1f}"
            f" MB logical, dedup {store.get('dedup_ratio', 1.0):.2f}x), "
            f"{store.get('degraded_loads_total', 0)} degraded loads")
    total = payload.get("hbm_bytes_total")
    budget = payload.get("hbm_budget_bytes")
    if total is not None:
        lines.append(f"hbm: {total / (1024 * 1024):.1f} MB resident"
                     + (f" / {budget / (1024 * 1024):.1f} MB budget"
                        if budget else " (no budget)"))
    return "\n".join(lines)


def format_adapters_table(payload: dict) -> str:
    """Render ``GET /admin/adapters`` as the ``adapters`` table: per-tenant
    residency, slot, attach cost, traffic."""
    cols = ("MODEL", "ADAPTER", "STATE", "SLOT", "TENANTS", "HBM_KB",
            "LAST_USED_S", "ATTACHES", "SERVED", "EST_ATTACH_MS")
    rows = [cols]
    for base, adapters in sorted((payload.get("models") or {}).items()):
        for aname, a in sorted(adapters.items()):
            rows.append((
                base, aname, a.get("state", "?"),
                str(a.get("slot")) if a.get("slot") is not None else "-",
                ",".join(a.get("tenants") or ()) or "-",
                f"{(a.get('hbm_bytes') or 0) / 1024:.1f}",
                f"{a.get('last_used_s_ago', 0):.1f}",
                str(a.get("attaches", 0)),
                str(a.get("served", 0)),
                f"{a.get('estimated_attach_ms', 0):.0f}",
            ))
    widths = [max(len(r[i]) for r in rows) for i in range(len(cols))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
             for r in rows]
    mixed = payload.get("multi_adapter_batches")
    if mixed is not None:
        lines.append(f"co-batched dispatches with >1 adapter: {mixed}")
    return "\n".join(lines)


def format_prefix_table(payload: dict) -> str:
    """Render ``GET /admin/prefix`` as the ``prefix`` table: per-model
    radix-tree size, hit rate, CoW/eviction traffic."""
    cols = ("MODEL", "NODES", "PAGES", "HITS", "MISSES", "HIT_RATE",
            "COW", "EVICTIONS", "RECLAIMABLE", "SHARED_NOW")
    rows = [cols]
    for model, p in sorted((payload.get("models") or {}).items()):
        rows.append((
            model, str(p.get("nodes", 0)), str(p.get("pages", 0)),
            str(p.get("hits", 0)), str(p.get("misses", 0)),
            f"{p.get('hit_rate', 0.0):.3f}",
            str(p.get("cow_copies", 0)), str(p.get("evictions", 0)),
            str(p.get("reclaimable_pages", 0)),
            str(p.get("kv_shared_blocks", 0)),
        ))
    widths = [max(len(r[i]) for r in rows) for i in range(len(cols))]
    return "\n".join("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                     for r in rows)


def format_slo_table(payload: dict) -> str:
    """Render ``GET /admin/slo`` as the ``slo`` table: per-(key, lane)
    goodput, outcome counts, fast/slow burn with alarm flags, then the
    per-tenant usage ledger (a merged fleet view renders the same)."""
    cols = ("KEY", "LANE", "OBJ_MS", "TARGET", "GOOD", "DEGR", "LATE",
            "SHED", "ERR", "GOODPUT", "BURN_FAST", "BURN_SLOW", "ALARM")
    rows = [cols]
    for key, lanes in sorted((payload.get("models") or {}).items()):
        for lane, t in sorted(lanes.items()):
            obj = t.get("objective", {})
            wins = t.get("windows", {})
            fast, slow = wins.get("fast", {}), wins.get("slow", {})
            alarm = ("fast" if fast.get("alarm")
                     else "slow" if slow.get("alarm") else "-")
            gp = t.get("goodput_ratio")
            outcomes = t.get("outcomes", {})
            rows.append((
                key, lane,
                f"{obj.get('latency_objective_ms', 0):g}",
                f"{obj.get('availability_target', 0):g}",
                str(outcomes.get("good", 0)),
                str(outcomes.get("degraded", 0)),
                str(outcomes.get("late", 0)),
                str(outcomes.get("shed", 0)),
                str(outcomes.get("error", 0)),
                f"{gp:.3f}" if gp is not None else "-",
                f"{fast.get('burn_rate', 0):g}",
                f"{slow.get('burn_rate', 0):g}",
                alarm,
            ))
    widths = [max(len(r[i]) for r in rows) for i in range(len(cols))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
             for r in rows]
    usage = payload.get("usage") or {}
    if usage:
        ucols = ("TENANT", "REQS", "DEVICE_MS", "KV_BLOCK_S",
                 "PREFIX_SAVED_TOK", "ATTACHES", "ATTACH_MS")
        urows = [ucols]
        for key, row in sorted(usage.items()):
            urows.append((
                key, str(row.get("requests", 0)),
                f"{row.get('device_ms', 0):.1f}",
                f"{row.get('kv_block_seconds', 0):.1f}",
                str(row.get("prefix_saved_tokens", 0)),
                str(row.get("attaches", 0)),
                f"{row.get('attach_ms', 0):.1f}",
            ))
        uw = [max(len(r[i]) for r in urows) for i in range(len(ucols))]
        lines.append("")
        lines += ["  ".join(c.ljust(w) for c, w in zip(r, uw)).rstrip()
                  for r in urows]
    if payload.get("replicas_merged"):
        lines.append(f"fleet view: {payload['replicas_merged']} replicas "
                     "merged (burn rates recomputed from summed windows)")
    return "\n".join(lines)


def format_autoscale_table(payload: dict) -> str:
    """Render ``GET /admin/autoscale`` as the ``autoscale`` table: per-key
    demand forecast, learned keep-warm window, next predicted arrival, and
    the planned pre-warm, then the plane's mode/degradation line and the
    pre-warm hit/miss counters."""
    cols = ("KEY", "ARRIVALS", "FORECAST_RPS", "KEEPWARM_S", "NEXT_IN_S",
            "LAST_SEEN_S", "PREWARMS", "PLANNED")
    rows = [cols]
    for key, m in sorted((payload.get("models") or {}).items()):
        def num(v, fmt="{:.2f}"):
            return fmt.format(v) if v is not None else "-"

        prewarms = sum((m.get("prewarms_by_cause") or {}).values())
        rows.append((
            key, str(m.get("arrivals", 0)),
            num(m.get("forecast_rps")),
            num(m.get("keepwarm_window_s"), "{:.1f}"),
            num(m.get("next_expected_in_s")),
            num(m.get("last_arrival_s_ago"), "{:.1f}"),
            str(prewarms),
            m.get("planned") or "-",
        ))
    widths = [max(len(r[i]) for r in rows) for i in range(len(cols))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
             for r in rows]
    c = payload.get("counters") or {}
    lines.append(
        f"mode: {payload.get('mode', '?')}"
        + (f" (degraded to reactive for "
           f"{payload.get('degraded_for_s')}s)" if payload.get("degraded")
           else "")
        + f"  prewarms: {c.get('prewarms', 0)}"
          f" (hits {c.get('prewarm_hits', 0)},"
          f" misses {c.get('prewarm_misses', 0)},"
          f" shed-on-budget {c.get('prewarm_shed_budget', 0)})")
    return "\n".join(lines)


# The admin tables: subcommand -> (route, formatter, help).
ADMIN_TABLES = {
    "models": ("/admin/models", format_models_table,
               "residency table of a running server (state, tier, HBM, family ladder)"),
    "adapters": ("/admin/adapters", format_adapters_table,
                 "per-tenant adapter residency table of a running server"),
    "prefix": ("/admin/prefix", format_prefix_table,
               "prefix KV cache table of a running server (nodes, pages, hit rate)"),
    "slo": ("/admin/slo", format_slo_table,
            "SLO, goodput and usage-ledger table of a running server"),
    "autoscale": ("/admin/autoscale", format_autoscale_table,
                  "autoscaler table of a running server (forecast, keep-warm, pre-warms)"),
}


def cmd_admin_table(args) -> int:
    """GET one admin route of a running server and print its table (or,
    with ``--json``, the body)."""
    import urllib.request

    route, fmt, _ = ADMIN_TABLES[args.cmd]
    with urllib.request.urlopen(args.url.rstrip("/") + route, timeout=10) as resp:
        payload = json.loads(resp.read().decode())
    print(json.dumps(payload, indent=2) if args.json else fmt(payload))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpuserve-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("serve", help="run the HTTP serving stack")
    sp.add_argument("--config", default=None, help="YAML/JSON config path")
    sp.add_argument("--profile", default=None, help="named profile in the config")
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="device to serve on (default cuda)")
    sp.add_argument("--port", type=int, default=None)
    sp.add_argument("--host", default=None, help="bind address (0.0.0.0 for containers)")
    sp.set_defaults(fn=cmd_serve)
    sp = sub.add_parser("list-models", help="print the registered model zoo")
    sp.set_defaults(fn=cmd_list_models)
    for name, (route, _, help_text) in ADMIN_TABLES.items():
        sp = sub.add_parser(name, help=help_text)
        sp.add_argument("--url", default="http://127.0.0.1:8000")
        sp.add_argument("--json", action="store_true",
                        help=f"raw {route} JSON instead of the table")
        sp.set_defaults(fn=cmd_admin_table)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
