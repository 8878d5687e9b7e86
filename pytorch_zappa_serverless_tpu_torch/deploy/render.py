"""Deploy artifact rendering: the server image and its H100 warm pool,
rendered from a ServeConfig.

- ``Dockerfile``   the server image: a CUDA *devel* base (the kernels build
                   with ``nvcc`` at first use), the port's package, the
                   ``serve`` command on the mounted config;
- ``config.json``  the serving profile the Dockerfile's command reads at
                   ``/etc/tpuserve/config.json`` (``config.dump_config`` of
                   the same ServeConfig, so it loads back equal);
- ``service.yaml`` (``cloudrun`` only) the Cloud Run service fronting the pool;
- ``warmpool.sh``  an H100 VM's bootstrap: ``cli warm`` builds the kernels
                   into ``build/`` and captures every bucket, then a
                   supervised ``cli serve``;
- ``undeploy.sh``  the teardown: the service, then the named GPU VMs;
- ``deploy.json``  the machine-readable summary.

Rendering is offline and pulls nothing; applying the artifacts (``docker
build``, ``gcloud run deploy``, ...) is the operator's step.
"""

from __future__ import annotations

import json
from pathlib import Path

from ..config import ServeConfig, dump_config

# A CUDA devel image: the kernels (ops/csrc/*.cu) build with nvcc at first
# use and the host library (native/hostops.cpp) with g++; NVIDIA's PyTorch
# image carries both with torch, numpy and Pillow.
BASE_IMAGE = "nvcr.io/nvidia/pytorch:24.08-py3"

_DOCKERFILE = """\
# The kernels build with nvcc at first use, into /srv/build, so the base is a
# CUDA devel image; {base} carries nvcc, g++, torch, numpy and Pillow.
FROM {base}
WORKDIR /srv
COPY pytorch_zappa_serverless_tpu_torch ./pytorch_zappa_serverless_tpu_torch
# Model weights are mounted (GCS fuse / volume) at /srv/assets and the
# profile at /etc/tpuserve/config.json, never baked into the image: the image
# stays small and weights roll independently.
EXPOSE {port}
CMD ["python", "-m", "pytorch_zappa_serverless_tpu_torch.cli", "serve", \\
     "--config", "/etc/tpuserve/config.json", "--port", "{port}", \\
     "--host", "0.0.0.0"]
"""

_SERVICE_YAML = """\
# Cloud Run service fronting the H100 warm pool ({profile} profile).
# Cloud Run terminates HTTP/autoscale/IAM; each instance proxies to a warm
# GPU VM from the pool (the keep-warm equivalent: VMs hold their built
# kernels and captured graphs resident).
apiVersion: serving.knative.dev/v1
kind: Service
metadata:
  name: tpuserve-{profile}
spec:
  template:
    metadata:
      annotations:
        autoscaling.knative.dev/minScale: "1"   # keep-warm: never scale to zero
    spec:
      containerConcurrency: 64
      containers:
        - image: IMAGE_URL
          ports: [{{containerPort: {port}}}]
          env:
            - {{name: TPUSERVE_PROFILE, value: "{profile}"}}
"""

_UNDEPLOY_SH = """\
#!/usr/bin/env bash
# Tear down the {profile} deployment.
# Deletes the Cloud Run service fronting the pool, then the GPU pool VMs the
# operator names (this repo renders VM *bootstrap*, not provisioning, so it
# cannot discover the pool: pass POOL_VMS="vm-1 vm-2" ZONE=<zone>).
# Idempotent: a resource that is already gone is success; any OTHER failure
# (auth, wrong region/zone, quota) is reported and fails the script — a
# teardown that silently leaves GPU VMs billing is the worst outcome.
set -uo pipefail
: "${{PROJECT:?set PROJECT}}" "${{REGION:?set REGION}}"
failed=0

delete_or_gone() {{  # $1 human name; rest: the gcloud delete command
  local what="$1"; shift
  local out
  if out=$("$@" --quiet 2>&1); then
    echo "deleted: $what"
  elif echo "$out" | grep -Eq "NOT_FOUND|could not be found|does not exist|was not found"; then
    echo "already gone: $what"
  else
    echo "FAILED to delete $what:" >&2
    echo "$out" >&2
    failed=1
  fi
}}

delete_or_gone "Cloud Run service tpuserve-{profile}" \\
    gcloud run services delete tpuserve-{profile} \\
    --project "$PROJECT" --region "$REGION"
if [ -n "${{POOL_VMS:-}}" ]; then
  : "${{ZONE:?set ZONE for POOL_VMS deletion}}"
  for vm in $POOL_VMS; do
    delete_or_gone "GPU VM $vm" \\
        gcloud compute instances delete "$vm" --project "$PROJECT" --zone "$ZONE"
  done
else
  echo "note: no POOL_VMS given — GPU pool VMs (if any) are still running" >&2
fi
if [ "$failed" -ne 0 ]; then
  echo "tpuserve {profile}: undeploy INCOMPLETE (see errors above)" >&2
  exit 1
fi
echo "tpuserve {profile}: undeployed"
"""

_WARMPOOL_SH = """\
#!/usr/bin/env bash
# H100 VM warm pool bootstrap ({profile}). Run once per pool VM, with the
# repository checked out at /srv/tpuserve (nothing is pip-installed: the VM
# image carries the CUDA toolkit, torch, numpy and Pillow).
set -euo pipefail
cd /srv/tpuserve
# Build every kernel (one nvcc per ops/csrc/*.cu, kept in build/ for every
# later process) and capture every bucket once: the profile is known to
# build and serve before the pool takes traffic.
python -m pytorch_zappa_serverless_tpu_torch.cli warm \\
    --config /etc/tpuserve/config.json --platform cuda
# Supervision loop: a server that exits (a fatal lane, a crash; the job
# journal replays on restart) is restarted here.  Signaling THIS supervisor
# (INT/TERM) forwards SIGINT to the server child, which runs its graceful
# shutdown, then stops the loop; without the trap a signal here would be
# deferred by bash while the server kept serving and billing.
stop() {{
  trap - INT TERM
  [ -n "${{child:-}}" ] && kill -INT "$child" 2>/dev/null
  wait "${{child:-}}" 2>/dev/null
  exit 0
}}
trap stop INT TERM
while true; do
  python -m pytorch_zappa_serverless_tpu_torch.cli serve \\
      --config /etc/tpuserve/config.json --platform cuda --port {port} --host 0.0.0.0 &
  child=$!
  wait "$child" && rc=0 || rc=$?
  echo "tpuserve exited rc=$rc; restarting in ${{RESTART_DELAY_S:-5}}s" >&2
  sleep "${{RESTART_DELAY_S:-5}}" &
  wait $!
done
"""


def render_deploy(cfg: ServeConfig, target: str = "cloudrun",
                  out_dir: str | Path = "deploy_out") -> dict:
    """Write the artifacts for ``target`` (``cloudrun`` or ``local``) under
    ``out_dir``; returns the summary written to ``deploy.json``."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    files = {
        "Dockerfile": _DOCKERFILE.format(base=BASE_IMAGE, port=cfg.port),
        "config.json": dump_config(cfg),
        "warmpool.sh": _WARMPOOL_SH.format(profile=cfg.profile, port=cfg.port),
        "undeploy.sh": _UNDEPLOY_SH.format(profile=cfg.profile),
    }
    if target == "cloudrun":
        files["service.yaml"] = _SERVICE_YAML.format(profile=cfg.profile, port=cfg.port)
    summary = {
        "target": target,
        "profile": cfg.profile,
        "models": [m.name for m in cfg.models],
        "files": sorted(files),
        "out_dir": str(out),
    }
    files["deploy.json"] = json.dumps(summary, indent=2)
    for name, content in files.items():
        (out / name).write_text(content)
    return summary
