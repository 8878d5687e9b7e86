"""Command line of the PyTorch/CUDA port.

- ``serve``  run the HTTP serving stack::

      python -m pytorch_zappa_serverless_tpu_torch.cli serve \\
          --config profile.yaml --platform cuda

  ``--platform`` defaults to ``cuda``; without a GPU the command fails
  unless ``--platform cpu`` asks for the CPU.  With ``drain_timeout_s > 0``
  in the profile, SIGTERM drains gracefully (``/healthz`` and new work 503,
  in-flight work given the budget) before the server stops; a second
  SIGTERM skips the drain.
  ``--ingest-workers N`` starts N acceptor worker processes on the binary
  lane's ingest port (``ingest_port``, else the port + 1).
- ``warm``  build every model and capture every bucket, print the build's
  numbers as one JSON line, and exit.  The port has no compile cache: what
  ``warm`` builds is not kept, so it measures a cold start and checks that
  the profile builds; it warms nothing for the next process.
- ``fleet``  the fleet router (``serving/fleet.py``) in front of running
  replicas (``--replicas url,url``) or ``--spawn N`` local ``cli serve``
  ones, each on ``--platform`` (CUDA unless ``cpu``); ``--disagg`` with
  ``--prefill-replicas`` serves ``:generate`` disaggregated::

      python -m pytorch_zappa_serverless_tpu_torch.cli fleet \\
          --config fleet.json --spawn 2 --port 8080
- ``stage``  convert every configured checkpoint once (a diffusers SD-1.5
  directory included) into ``--out``'s asset tree, with the
  ``config.json`` that points into it under ``--mount-root``; prints the
  summary (``stage.json``).  Nothing runs on a GPU::

      python -m pytorch_zappa_serverless_tpu_torch.cli stage \\
          --config profile.json --out stage_out --mount-root /srv/assets
- ``deploy``  render the server image and the H100 pool around a profile
  (``Dockerfile``, ``config.json``, ``warmpool.sh``, ``undeploy.sh``,
  ``deploy.json``, and ``service.yaml`` for ``--target cloudrun``) into
  ``--out``, offline; prints the summary.
- ``list-models``  print the registered model zoo.
- ``models``, ``adapters``, ``prefix``, ``slo``, ``autoscale``, ``perf``  HTTP
  clients of a running server's ``/admin/models``, ``/admin/adapters``,
  ``/admin/prefix``, ``/admin/slo``, ``/admin/autoscale`` and
  ``/admin/perf``: each prints its table (``--json`` the raw body)::

      python -m pytorch_zappa_serverless_tpu_torch.cli slo --url http://127.0.0.1:8000
- ``profile``  a ``torch.profiler`` window over a running server's live
  traffic, written as a Chrome trace (``POST /debug/trace``).
- ``tail``  print (``-f``: follow) the structured log file
  (``TPUSERVE_LOG_FILE``) a line a record, filtered by ``--level``,
  ``--grep`` and ``--trace``.
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
    if args.ingest_workers is not None:
        cfg.ingest_workers = args.ingest_workers
    run(cfg, device=args.platform)
    return 0


def _urls(raw: str | None) -> list[str]:
    return [u.strip() for u in (raw or "").split(",") if u.strip()]


def cmd_fleet(args) -> int:
    """Run the fleet router (``serving/fleet.py``) in front of N replicas:
    running ones (``--replicas url,url``) or spawned here (``--spawn N``:
    one ``cli serve`` subprocess a replica on ``spawn_base_port + i``, with
    ``TPUSERVE_PORT`` and, under ``journal_dir``, a journal of its own).
    Spawned replicas serve on ``--platform`` (CUDA unless ``cpu``); the
    router itself touches no device."""
    import os
    import subprocess
    from pathlib import Path

    from .serving.fleet import run

    cfg = load_config(args.config, args.profile)
    fc = cfg.fleet
    if args.port is not None:
        fc.port = args.port
    if args.host:
        fc.host = args.host
    if args.replicas:
        fc.replicas = _urls(args.replicas)
    if args.spawn is not None:
        fc.spawn = args.spawn
    if args.disagg:
        fc.disagg = True
    if args.prefill_replicas:
        fc.prefill_replicas = _urls(args.prefill_replicas)
    if fc.spawn and args.platform == "cuda":
        from .engine.loader import resolve_device

        resolve_device("cuda")  # raises without CUDA: no CPU replicas in its place
    urls = [str(u) for u in fc.replicas]
    spawned: dict[str, subprocess.Popen] = {}  # url -> process
    next_replica = [0]  # the next spawned replica's index (scale-out too)

    def spawn_replica() -> str:
        """One ``cli serve`` subprocess on the next port: the boot-time
        ``--spawn`` path and the router's scale-out hook."""
        i = next_replica[0]
        next_replica[0] += 1
        port = fc.spawn_base_port + i
        env = dict(os.environ)
        env["TPUSERVE_PORT"] = str(port)
        if cfg.journal_dir:
            # Durability is a replica's own: each journal replays into the
            # process that owns it.
            env["TPUSERVE_JOURNAL_DIR"] = str(Path(cfg.journal_dir).expanduser()
                                              / f"replica-{i}")
        cmd = [sys.executable, "-m", "pytorch_zappa_serverless_tpu_torch.cli", "serve",
               "--platform", args.platform]
        if args.config:
            cmd += ["--config", args.config]
        if args.profile:
            cmd += ["--profile", args.profile]
        url = f"http://127.0.0.1:{port}"
        spawned[url] = subprocess.Popen(cmd, env=env)
        return url

    for _ in range(fc.spawn):
        urls.append(spawn_replica())
    if not urls:
        print("fleet: no replicas (configure fleet.replicas, pass --replicas, or --spawn N)",
              file=sys.stderr)
        return 2
    fc.replicas = urls
    router_ref: list = []

    def signal_replica(replica_id: str, kill: bool) -> bool:
        # Resolved through the live registry, so replicas the scale actuator
        # spawned later are reachable too.
        r = router_ref[0].registry.get(replica_id) if router_ref else None
        proc = spawned.get(r.url) if r is not None else None
        if proc is None or proc.poll() is not None:
            return False
        proc.kill() if kill else proc.terminate()
        return True

    try:
        run(fc, kill_hook=lambda rid: signal_replica(rid, kill=True),
            terminate_hook=lambda rid: signal_replica(rid, kill=False),
            spawn_hook=spawn_replica if (fc.spawn or args.spawn is not None) else None,
            on_router=router_ref.append)
    finally:
        for proc in spawned.values():
            if proc.poll() is None:
                proc.terminate()
        for proc in spawned.values():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    return 0


def cmd_warm(args) -> int:
    """Build the profile's engine (every bucket captured), print the
    reference's JSON keys, and exit."""
    from .engine.loader import build_engine

    cfg = load_config(args.config, args.profile)
    engine = build_engine(cfg, args.platform, warmup=True)
    try:
        print(json.dumps({
            "cold_start_seconds": round(engine.cold_start_seconds, 3),
            "compile_seconds": round(engine.clock.total_seconds, 3),
            "executables": len(engine.clock.entries),
            "models": dict(engine.build_seconds),
        }))
    finally:
        engine.shutdown()
    return 0


def cmd_stage(args) -> int:
    """Stage the profile's models (``deploy/stage.py``); ``--platform`` is
    the reference's flag: staging builds on the CPU and the meta device
    whatever it names."""
    from .deploy.stage import stage_assets

    cfg = load_config(args.config, args.profile)
    print(json.dumps(stage_assets(cfg, out_dir=args.out, mount_root=args.mount_root),
                     indent=2))
    return 0


def cmd_deploy(args) -> int:
    from .deploy.render import render_deploy

    cfg = load_config(args.config, args.profile)
    print(json.dumps(render_deploy(cfg, target=args.target, out_dir=args.out), indent=2))
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
def format_perf_table(payload: dict) -> str:
    """Render ``GET /admin/perf`` as the ``perf`` table: event-loop lag, each
    model's rolling gauges, its ingest stages' p50/p99, then the top
    collapsed stacks."""
    from .serving.perfplane import INGEST_STAGES, hist_quantile

    lines = []
    lag = payload.get("loop_lag") or {}
    hist = lag.get("hist") or {}
    p50, p99 = hist_quantile(hist, 0.5), hist_quantile(hist, 0.99)
    lines.append(f"loop lag: p50 {p50 if p50 is not None else '-'} ms  "
                 f"p99 {p99 if p99 is not None else '-'} ms  "
                 f"max {lag.get('max_ms', '-')} ms  ticks {lag.get('ticks', 0)}  "
                 f"interval {lag.get('interval_s', '-')}s")

    def table(cols, rows):
        rows = [cols] + rows
        widths = [max(len(r[i]) for r in rows) for i in range(len(cols))]
        lines.append("")
        lines.extend("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip() for r in rows)

    models = payload.get("models") or {}
    if models:
        def num(g, key, fmt="{:.2f}"):
            v = g.get(key)
            return fmt.format(v) if v is not None else "-"

        table(("MODEL", "SAMPLES/S", "TOK/S", "STEP_MS", "UTIL%", "MFU%", "TTFT_P50",
               "ITL_P50"),
              [(name, num(g, "samples_per_s"), num(g, "tokens_per_s"),
                num(g, "step_ms", "{:.3f}"), num(g, "device_util_pct", "{:.1f}"),
                num(g, "mfu_pct"), num(g, "ttft_p50_ms"), num(g, "itl_p50_ms"))
               for name, g in sorted(models.items())])
    ingest = payload.get("ingest") or {}
    if ingest:
        rows = []
        for model, stages in sorted(ingest.items()):
            ordered = ([x for x in INGEST_STAGES if x in stages]
                       + [x for x in stages if x not in INGEST_STAGES])
            for stage in ordered:
                snap = stages[stage]
                q50, q99 = (hist_quantile(snap, q) for q in (0.5, 0.99))
                rows.append((model, stage, f"{q50:.3f}" if q50 is not None else "-",
                             f"{q99:.3f}" if q99 is not None else "-",
                             str(snap.get("count", 0))))
        table(("MODEL", "STAGE", "P50_MS", "P99_MS", "COUNT"), rows)
    stacks = payload.get("stacks") or {}
    if stacks.get("stacks"):
        lines.append("")
        lines.append(f"top stacks ({stacks.get('samples', 0)} samples @ "
                     f"{stacks.get('hz', '-')} Hz):")
        for row in stacks["stacks"][:10]:
            stack = row["stack"]
            if len(stack) > 100:
                stack = "..." + stack[-97:]
            lines.append(f"  {row['pct']:5.1f}%  {row['seconds']:8.2f}s  {stack}")
    return "\n".join(lines)


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
    "perf": ("/admin/perf", format_perf_table,
             "perf-plane table of a running server (loop lag, gauges, ingest stages, "
             "stacks)"),
}


def cmd_profile(args) -> int:
    """A trace capture on a running server (``POST /debug/trace``): prints
    the answer (the capture's directory and files)."""
    import urllib.request

    req = urllib.request.Request(args.url.rstrip("/") + "/debug/trace",
                                 data=json.dumps({"seconds": args.seconds}).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=args.seconds + 30) as resp:
        print(resp.read().decode())
    return 0


def cmd_tail(args) -> int:
    """Print the structured log file (``TPUSERVE_LOG_FILE``) one line a
    record, with level, substring and trace filters; ``-f`` follows it."""
    import os
    import time as _time

    path = args.file or os.environ.get("TPUSERVE_LOG_FILE")
    if not path:
        print("no log file: pass a path or set TPUSERVE_LOG_FILE", file=sys.stderr)
        return 2
    levels = {"debug": 10, "info": 20, "warning": 30, "error": 40}
    min_level = levels.get(args.level, 20)

    def render(line: str):
        line = line.strip()
        if not line:
            return
        try:
            rec = json.loads(line)
        except ValueError:
            print(line)
            return
        if levels.get(str(rec.get("level", "info")), 20) < min_level:
            return
        if args.grep and args.grep not in line:
            return
        if args.trace and rec.get("trace_id") != args.trace:
            return
        raw_ts = rec.pop("ts", None)
        try:
            ts = _time.strftime("%H:%M:%S", _time.localtime(float(raw_ts)))
        except (TypeError, ValueError):
            # A foreign record (an ISO string, say): shown as it is.
            ts = str(raw_ts) if raw_ts is not None else "--:--:--"
        level = str(rec.pop("level", "info")).upper()
        logger = rec.pop("logger", "-")
        msg = rec.pop("msg", "")
        rest = " ".join(f"{k}={json.dumps(v)}" for k, v in rec.items())
        print(f"{ts} {level:<7} {logger:<18} {msg}" + (f"  {rest}" if rest else ""))

    try:
        f = open(os.path.expanduser(path))
    except FileNotFoundError:
        print(f"log file not found: {path} (the server writes it once TPUSERVE_LOG_FILE is "
              "set)", file=sys.stderr)
        return 2
    with f:
        if args.follow and not args.from_start:
            f.seek(0, os.SEEK_END)
        try:
            while True:
                line = f.readline()
                if line:
                    render(line)
                elif args.follow:
                    _time.sleep(0.25)
                else:
                    return 0
        except KeyboardInterrupt:
            return 0


def cmd_admin_table(args) -> int:
    """GET one admin route of a running server and print its table (or,
    with ``--json``, the body)."""
    import urllib.request

    route, fmt, _ = ADMIN_TABLES[args.cmd]
    if getattr(args, "top", None) is not None:
        route += f"?top={args.top}"
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
    sp.add_argument("--ingest-workers", type=int, default=None,
                    help="SO_REUSEPORT acceptor worker processes on the binary lane's ingest "
                         "port (0: the main port alone)")
    sp.set_defaults(fn=cmd_serve)
    sp = sub.add_parser("fleet", help="run the fleet router in front of N replicas")
    sp.add_argument("--config", default=None, help="YAML/JSON config path")
    sp.add_argument("--profile", default=None, help="named profile in the config")
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="device the spawned replicas serve on (default cuda)")
    sp.add_argument("--port", type=int, default=None, help="router port")
    sp.add_argument("--host", default=None, help="router bind address")
    sp.add_argument("--replicas", default=None, help="comma-separated replica base URLs")
    sp.add_argument("--spawn", type=int, default=None,
                    help="spawn N local `cli serve` replicas")
    sp.add_argument("--disagg", action="store_true",
                    help="disaggregated prefill/decode with live KV migration and KV-aware "
                         "failover")
    sp.add_argument("--prefill-replicas", default=None,
                    help="comma-separated replica URLs tagged prefill (disaggregated mode)")
    sp.set_defaults(fn=cmd_fleet)
    sp = sub.add_parser("warm", help="build every model and capture every bucket, print the "
                                     "build's numbers, exit (no compile cache: nothing is "
                                     "kept for the next process)")
    sp.add_argument("--config", default=None, help="YAML/JSON config path")
    sp.add_argument("--profile", default=None, help="named profile in the config")
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="device to build on (default cuda)")
    sp.set_defaults(fn=cmd_warm)
    sp = sub.add_parser("stage", help="build the deployable asset tree (convert "
                                      "checkpoints, copy assets)")
    sp.add_argument("--config", default=None, help="YAML/JSON config path")
    sp.add_argument("--profile", default=None, help="named profile in the config")
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="the reference's flag; staging places nothing on a device")
    sp.add_argument("--out", default="stage_out")
    sp.add_argument("--mount-root", default="/srv/assets",
                    help="path where the asset tree is mounted on serving hosts")
    sp.set_defaults(fn=cmd_stage)
    sp = sub.add_parser("deploy", help="render deploy artifacts")
    sp.add_argument("--config", default=None, help="YAML/JSON config path")
    sp.add_argument("--profile", default=None, help="named profile in the config")
    sp.add_argument("--target", default="cloudrun", choices=["cloudrun", "local"])
    sp.add_argument("--out", default="deploy_out")
    sp.set_defaults(fn=cmd_deploy)
    sp = sub.add_parser("list-models", help="print the registered model zoo")
    sp.set_defaults(fn=cmd_list_models)
    for name, (route, _, help_text) in ADMIN_TABLES.items():
        sp = sub.add_parser(name, help=help_text)
        sp.add_argument("--url", default="http://127.0.0.1:8000")
        sp.add_argument("--json", action="store_true",
                        help=f"raw {route} JSON instead of the table")
        if name == "perf":
            sp.add_argument("--top", type=int, default=20,
                            help="stack-table depth (bounded by the server)")
        sp.set_defaults(fn=cmd_admin_table)
    sp = sub.add_parser("profile", help="a torch.profiler trace of a running server's live "
                                        "traffic (POST /debug/trace)")
    sp.add_argument("--url", default="http://127.0.0.1:8000")
    sp.add_argument("--seconds", type=float, default=2.0)
    sp.set_defaults(fn=cmd_profile)
    sp = sub.add_parser("tail", help="print or follow the structured log file")
    sp.add_argument("file", nargs="?", default=None,
                    help="log file (default: $TPUSERVE_LOG_FILE)")
    sp.add_argument("-f", "--follow", action="store_true")
    sp.add_argument("--from-start", action="store_true",
                    help="with -f, print the existing lines before following")
    sp.add_argument("--level", default="info", choices=["debug", "info", "warning", "error"])
    sp.add_argument("--grep", default=None, help="only lines containing this substring")
    sp.add_argument("--trace", default=None, metavar="TRACE_ID",
                    help="only records stamped with this trace_id")
    sp.set_defaults(fn=cmd_tail)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
