"""The port stands alone: it imports torch, never JAX, flax, ``ml_dtypes``, the
JAX package or ``transformers`` (the card's machine has none), nor
``safetensors``, which staging, the native format and the diffusers
converters never load; and its entry points run on CUDA unless the caller
asks for the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "pytorch_zappa_serverless_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "ml_dtypes", "pytorch_zappa_serverless_tpu",
             "transformers")


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_importing_the_port_loads_no_jax():
    mods = _port_modules()
    assert len(mods) >= 20 and "pytorch_zappa_serverless_tpu_torch.serving.server" in mods
    for lane in ("serving.generation", "serving.kvcache", "serving.prefixcache",
                 "ops.paged_attention", "engine.genkernels", "faults",
                 "serving.resilience", "serving.watchdog", "serving.lifecycle",
                 "serving.ckptstore", "engine.streamio", "serving.wire", "serving.tracing",
                 "serving.durability", "utils.xplane", "tools.crashtest", "serving.kvmigrate",
                 "ops.lora", "serving.adapters", "serving.perfplane", "serving.acceptors",
                 "serving.acceptor_telemetry", "serving.httpframe", "serving.fleet",
                 "serving.httpclient", "deploy", "deploy.stage", "deploy.render",
                 "engine.tensorfile", "parallel", "parallel.mesh", "parallel.lockstep",
                 "parallel.ring_attention", "benchmark", "utils.cudatime", "tools.replay",
                 "tools.tracedump"):
        assert f"pytorch_zappa_serverless_tpu_torch.{lane}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        # The Prometheus render, with the resilience hub wired, loads
        # nothing forbidden either.
        "from pytorch_zappa_serverless_tpu_torch.config import ServeConfig\n"
        "from pytorch_zappa_serverless_tpu_torch.faults import FaultInjector\n"
        "from pytorch_zappa_serverless_tpu_torch.serving.metrics import MetricsHub\n"
        "from pytorch_zappa_serverless_tpu_torch.serving.resilience import ResilienceHub\n"
        "hub = MetricsHub(); hub.resilience = ResilienceHub(ServeConfig())\n"
        "hub.faults = FaultInjector(); hub.ring('m').record(1.0, 2.0, 3.0)\n"
        "hub.resilience.model('m')\n"
        "assert 'tpuserve_requests_total' in hub.render_prometheus()\n"
        # A stream round trip (bf16 included) loads nothing forbidden.
        "import tempfile, torch\n"
        "from pytorch_zappa_serverless_tpu_torch.engine import weights as W\n"
        "p = tempfile.mkdtemp() + '/m.tpu.ckpt'\n"
        "W.save_stream({'w': torch.ones(3, dtype=torch.bfloat16)}, p)\n"
        "assert W.open_stream(p)[0]['w'].dtype == torch.bfloat16\n"
        # A bf16 frame and a journal round trip load nothing forbidden.
        "from pytorch_zappa_serverless_tpu_torch.serving import wire, durability\n"
        "items, _ = wire.unpack(bytes(wire.pack([torch.ones(2, dtype=torch.bfloat16)])))\n"
        "assert items[0].dtype == torch.bfloat16\n"
        "j = durability.JobJournal(tempfile.mkdtemp())\n"
        "j.append({'ev': 'submit', 'id': 'a', 'model': 'm', 'payload': b'x'}); j.close()\n"
        "assert j.replay().jobs[0]['payload'] == b'x'\n"
        # A bf16 KV page through the migration wire loads nothing forbidden.
        "from pytorch_zappa_serverless_tpu_torch.serving import kvmigrate\n"
        "pg = torch.ones(2, 4, 8, dtype=torch.bfloat16)\n"
        "rec = kvmigrate.pack_page(0, pg, pg)\n"
        "assert torch.equal(kvmigrate.unpack_page(rec, (2, 4, 8), 'bfloat16')[1], pg)\n"
        # An adapter installed into a bf16 stack pool and applied loads
        # nothing forbidden.
        "from pytorch_zappa_serverless_tpu_torch.ops import lora\n"
        "dims = {'q': (8, 8)}\n"
        "host = {'layer0': lora.zero_stacks(2, 4, dims)}\n"
        "lora.install_adapter(host, 1, W.init_lora(1, dims, 4, seed=1), scaling=2.0)\n"
        "dev = {'layer0': {'q': {h: torch.zeros(host['layer0']['q'][h].shape,\n"
        "                                       dtype=torch.bfloat16) for h in 'ab'}}}\n"
        "lora.write_slot(dev, host, 1)\n"
        "x = torch.ones(2, 8, dtype=torch.bfloat16)\n"
        "y = lora.lora_apply(x, x, dev['layer0']['q'], torch.tensor([0, 1]))\n"
        "assert torch.equal(y[0], x[0]) and not torch.equal(y[1], x[1])\n"
        # A stage of a SD-1.5 diffusers directory, its render and the
        # staged tree's load (deploy/ and the native format) load nothing
        # forbidden, and not the safetensors package.
        "import numpy as np\n"
        "from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, load_config\n"
        "from pytorch_zappa_serverless_tpu_torch.deploy.render import render_deploy\n"
        "from pytorch_zappa_serverless_tpu_torch.deploy.stage import stage_assets\n"
        "from pytorch_zappa_serverless_tpu_torch.models import sd15\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('sd_diffusers', 'tests/sd_diffusers.py')\n"
        "D = importlib.util.module_from_spec(spec); spec.loader.exec_module(D)\n"
        "d = tempfile.mkdtemp()\n"
        "D.write_diffusers_dir(sd15.init_sd15_params(0, sd15.TINY), d + '/ckpt')\n"
        "mc = ModelConfig(name='sd15', checkpoint=d + '/ckpt', extra={'variant': 'tiny'})\n"
        "stage_assets(ServeConfig(models=[mc]), d + '/out', d + '/out/assets')\n"
        "render_deploy(load_config(d + '/out/config.json'), 'cloudrun', d + '/deploy')\n"
        "sd15.make_sd15_servable('sd15', load_config(d + '/out/config.json').models[0])\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN + ('safetensors',)!r})\n"
        "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_the_acceptor_workers_closure_loads_no_torch():
    """What an acceptor worker process imports (the acceptors module and
    with it the wire, tracing, logging, telemetry and framing modules) loads
    neither torch nor anything forbidden: a worker's crash takes no model
    state with it, and its start costs no libtorch load."""
    code = ("import json, sys\n"
            "import pytorch_zappa_serverless_tpu_torch.serving.acceptors as A\n"
            "import pytorch_zappa_serverless_tpu_torch.serving.acceptor_telemetry\n"
            "import pytorch_zappa_serverless_tpu_torch.serving.httpframe\n"
            "from pytorch_zappa_serverless_tpu_torch.serving import wire\n"
            "import numpy as np\n"
            "wire.unpack(bytes(wire.pack([np.ones(2, np.uint8), {'a': 1}])))\n"
            "hdr = wire._HDR.pack(wire.MAGIC, wire.VERSION, 0, 1)\n"
            "blk = wire._BLK.pack(wire.BF16_CODE, 1, 0) + wire._DIM.pack(2)\n"
            "items, _ = wire.unpack(hdr + blk + bytes(4), bf16_as_bits=True)\n"
            "assert items[0].dtype == np.int16\n"
            f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {('torch',) + FORBIDDEN!r})\n"
            "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_the_router_loads_no_aiohttp_and_its_client_no_torch():
    """The fleet router (``serving/fleet.py``) serves and calls on the
    standard library: importing it, and starting and stopping a router,
    loads no aiohttp (the port depends on none) and nothing forbidden;
    the HTTP client's closure, like the framing's, loads no torch."""
    code = ("import json, sys\n"
            "import pytorch_zappa_serverless_tpu_torch.serving.httpclient as C\n"
            "import pytorch_zappa_serverless_tpu_torch.serving.httpframe\n"
            "before = sorted(n for n in sys.modules if n.split('.')[0] == 'torch')\n"
            "import asyncio\n"
            "from pytorch_zappa_serverless_tpu_torch.config import FleetConfig\n"
            "from pytorch_zappa_serverless_tpu_torch.serving.fleet import FleetRouter\n"
            "async def go():\n"
            "    r = FleetRouter(FleetConfig(poll_interval_s=0.0))\n"
            "    port = await r.start('127.0.0.1', 0)\n"
            "    pool = C.ClientPool()\n"
            "    async with await pool.request('GET', f'http://127.0.0.1:{port}/healthz',\n"
            "                                  timeout=C.ClientTimeout(5, 1)) as resp:\n"
            "        assert resp.status == 503 and (await resp.json())['fleet_ok'] is False\n"
            "    await pool.close(); await r.stop()\n"
            "asyncio.run(go())\n"
            f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {('aiohttp',) + FORBIDDEN!r})\n"
            "print(json.dumps([before, bad]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [[], []]


def test_the_bench_and_its_tools_load_no_root_tool_and_no_aiohttp():
    """The bench's plane sections and the port's ``tools/replay.py`` and
    ``tools/tracedump.py`` load neither the root ``tools/`` scripts (the
    reference's ``replay.py``, ``crashtest.py``, ``tracedump.py``) nor aiohttp:
    importing them, synthesizing a trace, summarizing it, attributing a
    trace's stages and naming the sections load nothing from the root tools
    directory."""
    code = ("import json, sys, importlib\n"
            "from pathlib import Path\n"
            "import pytorch_zappa_serverless_tpu_torch.benchmark as B\n"
            "from pytorch_zappa_serverless_tpu_torch.tools import replay as R, tracedump as T\n"
            "from pytorch_zappa_serverless_tpu_torch.tools import crashtest\n"
            "tr = R.synth_trace('bursty', 3.0, 8.0, ['a', 'b'], seed=7)\n"
            "R.summarize([{'status': 200, 'latency_ms': 1.0} for _ in tr], 3.0, 500.0)\n"
            "T.stage_attribution({'tree': {'name': 'r', 'duration_ms': 2.0, 'children': []}})\n"
            "B.sections_to_run(); R.default_payload()\n"
            "tools = Path('tools').resolve()\n"
            "root = sorted(n for n, m in sys.modules.items() if getattr(m, '__file__', None)\n"
            "              and Path(m.__file__).resolve().parent == tools)\n"
            f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {('aiohttp',) + FORBIDDEN!r})\n"
            "print(json.dumps([root, bad]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [[], []]
    for path in (PORT / "benchmark.py", *sorted((PORT / "tools").glob("*.py"))):
        text = path.read_text()
        for name in ("replay", "crashtest", "tracedump"):
            assert f'"tools" / "{name}.py"' not in text and f"tools/{name}.py\")" not in text


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_the_jax_package(path):
    """Static scan: no absolute import of a forbidden top-level module, and
    no relative import that climbs out of the port's package."""
    depth = len(path.relative_to(ROOT).parts) - 1  # package levels above the file
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level <= depth, f"{path}:{node.lineno} climbs out of the port"
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_build_engine_needs_cuda_unless_cpu_asked(no_cuda):
    from pytorch_zappa_serverless_tpu_torch.config import ServeConfig
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine, resolve_device

    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_engine(ServeConfig(), device)
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    eng = build_engine(ServeConfig(), device="cpu")
    try:
        assert eng.device == torch.device("cpu") and eng.models == {}
    finally:
        eng.shutdown()


def test_cli_serve_defaults_to_cuda(no_cuda, tmp_path):
    from pytorch_zappa_serverless_tpu_torch import cli

    args = cli.build_parser().parse_args(["serve"])
    assert args.platform == "cuda"
    cfg = tmp_path / "empty.json"
    cfg.write_text(json.dumps({"port": 0, "models": []}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["serve", "--config", str(cfg)])


def test_yaml_is_imported_only_for_yaml_files(tmp_path):
    code = ("import sys, json\n"
            "from pytorch_zappa_serverless_tpu_torch.config import load_config\n"
            f"load_config({str(tmp_path / 'c.json')!r})\n"
            "print('yaml' in sys.modules)\n")
    (tmp_path / "c.json").write_text("{}")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"
