"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles the port's hand-written kernels from ``ops/csrc/``, one
   ``nvcc`` per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (and the edge cases each must take), with
   per-shape times (kernels and their library calls by ``device_ms``,
   launches queued behind a spin kernel; plain versions by CUDA events);
   ``int8_matmul`` at the BERT shapes, GPT-2 small's decode (M = 1, 8) and
   prefill (M = 512) shapes and its f32 lm head, Whisper-tiny's four (K, N)
   at M = 1, 4, 16 and its f32 lm head, two launches of each of two split-K
   shapes bitwise equal (GPT-2's, and Whisper's 4x384x384 with one K tile a
   cluster rank), and one GPT-2 position step, one BERT forward and one
   Whisper decoder position (M = 4) over distinct weights beside cuBLAS on
   the dequantised weights; at
   flash's 4096-token shape, a planted fault (the scale of a padded head
   dim) the tolerance must reject;
4. BERT path: ``build_engine`` with full-width BERT-base int8 (seed weights),
   the port's HTTP server on a free localhost port, ``:predict`` requests
   (``text``, ``input_ids``, an 8-element ``instances`` body) and
   ``/classify``, then ``/healthz``, ``/v1/models`` and ``/metrics``; the
   int8 kernel's launch count must equal its launches per forward times the
   forwards run; then each bucket's captured CUDA graph against the eager
   forward on the same batch, byte for byte, two batches replayed in turn,
   and exactly 72 ``int8_matmul`` launches a replay;
5. BERT parity: the served int8 forward against the same model with every
   projection routed through the plain version (eagerly), on the same
   weights and batch;
6. SD-1.5 path: ``build_engine`` with full-width SD-1.5 at 512x512, 20 DDIM
   steps in chunks of 4 (seed weights, from phase 22a's staged tree), the
   server, two ``:submit`` jobs
   polled on ``/v1/jobs/{id}`` to valid 512x512 PNGs, ``:predict`` → 405,
   ``/v1/models``, ``/healthz``, ``/metrics``; the flash kernel's launch
   count must be ten per UNet call; each chunk's replayed graph against the
   same chunk run eagerly (the latents byte for byte, exactly 40 flash
   launches a replay); the two jobs at once through ``runner.run_chunked``,
   their chunks taking turns on the one chunk graph, against each alone;
7. SD-1.5 parity: one UNet call with every long self-attention through the
   kernel, against the same with it routed through the plain version; and
   the PNG the job lane served for the first job against the same request
   through the same chunked route with the plain version;
8. GPT-2 path: ``build_engine`` with full-width GPT-2 small int8 (seed
   weights), batch buckets (1, 8), seq bucket 64, 32 new tokens; the server;
   ``:predict`` with ``text``, ``input_ids``, 8 ragged ``instances``, and one
   sampled request sent twice (the same answer both times); the GETs; the
   int8 kernel's launch count must be 49 per position step times 33 steps
   per generate call; the captured graphs (greedy and a sampled, filtered
   variant, at both buckets) against the eager call, byte for byte, exactly
   49 x 33 launches a replay; then prefill and teacher-forced step logits
   against the same model with the int8 product routed to its plain version;
9. fused decode: the bench's three lanes (``tools/bench_fused_decode``) on
   8 ragged prompts through the port's prefill; each fused kernel of one step
   against its plain version, per layer, and a planted fault (the key at
   pos[s] masked) the tolerance must reject; 32 teacher-forced steps of each
   fused lane against the unfused step (12 launches of each of the four
   entry points per step of its lane); each lane's captured step replayed
   32 times against 32 eager steps (tokens and caches byte for byte); ms per
   step of the three lanes, replayed and eager, and each kernel's per-launch
   time beside its bound; with ``--profile``, the per-phase
   ``%globaltimer`` stamps of one launch of each fused kernel
   (``tools/fused_ablation``);
10. vision path: ``build_engine`` with full-width ResNet-50 at 224x224
   (buckets 1, 4, 8, 32), ResNet-18 and EfficientNet-B0 (buckets 1, 8), seed
   weights; the native host library must load; the server; per model
   ``:predict`` with a raw PNG body, ``{"b64": ...}``, 8 b64 ``instances``
   of other sizes and aspect ratios, and the first image pre-decoded as a
   224x224x3 array (the raw, b64 and array answers equal); a JPEG body →
   200, a JPEG head with no image → 400; the GETs; no kernel of
   the port runs on this path (every count 0); 60 single PNGs in turn for
   the served p50; each bucket's replay against the eager forward byte for
   byte, two batches in turn; per-bucket device ms replayed and eager beside
   the FLOP bound; the served bf16 top-k against an fp32 eager run (TF32 off)
   within ``VISION_PROB_TOL``, top-1 agreeing on every decided row and on at
   least ``VISION_TOP1_MIN`` of 8; with ``--profile``, served ResNet-50 at
   bucket 32 and EfficientNet-B0 at bucket 8 eager against replayed;
11. Whisper path: ``build_engine`` with full-width Whisper-tiny (seed
   weights, buckets 1 and 4, 64 new tokens) twice, ``whisper_tiny`` on the
   int8 lane and ``whisper_bf16`` (the same builder) with f32 weights at
   rest; the server; ``:predict`` with a 3 s 16 kHz WAV, a 44.1 kHz stereo
   WAV, ``{"array", "rate"}``, ``{"b64"}``, a 4-WAV ``instances`` body and a
   65 s WAV (3 chunks), a WAV on the bf16 lane, and ``{"array",
   "temperature"}`` → 400; the GETs; exactly 2145 ``int8_matmul`` launches
   per int8 generate call; each bucket's replay against the eager call byte
   for byte, two batches in turn; the int8 lane's teacher-forced logits
   against the plain int8 product; host ms of WAV → log-mel per 30 s
   window; 20 single WAVs for the served p50; device ms per generate call
   replayed and eager, and of the encoder alone, per bucket; with
   ``--profile``, one int8 generate call at bucket 4 eager against replayed;
12. ViT-B/16 and ``bert_embed``: both at buckets (1, 8) (bert_embed at seq
   128), seed weights; PNG, b64 and ``instances`` bodies on ViT, ``text``,
   ``input_ids`` and ``instances`` on bert_embed (unit vectors within
   1e-5); every kernel count 0; replay against eager byte for byte; ViT
   bf16 against fp32 under phase 10's rules, bert_embed bf16 against fp32
   within ``EMBED_ATOL`` and ``EMBED_COS_MIN``; device ms per bucket;
13. ``:generate``: one server with four continuous lanes, seed weights at
   full width: GPT-2 small int8 on the slot pool (8 slots, 8-token segments,
   seq buckets 16, 64 and 128, 64 new tokens), the same model bf16 on the
   paged pool (16-token pages, 64-token prefill chunks, the prefix cache),
   the bf16 weights again on a page pool of one full sequence, and
   Whisper-tiny int8 on the slot pool (4 slots).  Over HTTP: 16 concurrent
   SSE streams (prompts of 5 to 120 tokens, budgets of 8 to 64, half
   greedy, half sampled with top-k and top-p) and one ``stream: false``
   request on each GPT-2 lane; a 104-token prompt cold, warm, and another
   sharing its 96-token prefix; two streams that overflow the small pool
   (one is evicted and re-admitted) and a burst that must shed 429 with
   Retry-After and the KV fields; four Whisper SSE streams of WAVs.  Every
   stream is held against the fixed route (teacher-forced logits) under the
   margin rule, the positions outside it printed; ``int8_matmul``'s launches
   exactly the lanes' graph runs (392 a GPT-2 segment, 264 a Whisper
   segment); every new graph (prefill, insert, segment, chunk, page copy)
   against the same calls eagerly on a second pool, byte for byte, and one
   stream the same from slot 0 and slot 7; TTFT, inter-token gaps,
   tokens/s, device ms a segment replayed and eager, and each lane's cold
   start (its pool and every graph it can run, captured before the load);
   then the prefix cache's chaos modes on the paged lane: ``poison`` fails
   every lookup (the request prefills cold, its tokens equal the cold
   ones) and ``cow`` copies every shared page of a hit (its tokens equal
   the warm ones, ``cow_copies`` counts the copies);
14. the failure path: one server with BERT-base int8 at (1, 8) x 128 and
   GPT-2 small int8 at (1,) x 64 with an 8-slot ``:generate`` lane, seed
   weights at full width, under ``retry_max_attempts`` 3,
   ``breaker_threshold`` 0.5, ``breaker_min_samples`` 4 and
   ``watchdog_interval_s`` 0.5; the fault-free answers first, then (1) a
   transient fault every second dispatch, three times: the answers
   byte-equal, ``dispatch_retries`` +3, ``int8_matmul`` launches exactly
   72 a dispatch that ran; (2) 200 ms of latency on one dispatch and six
   requests with ``X-Deadline-Ms: 50`` behind it: 504, counted, and no
   launch for the shed work; (3) a fatal fault on every BERT dispatch: the
   breaker opens, BERT fast-fails 503 with ``Retry-After`` while GPT-2's
   ``:predict`` and ``:generate`` answer byte-equal, then the watchdog
   rebuilds on the fatal cause; (4) once, a poisoned runner: eight
   concurrent ``/healthz`` 503 through one shared probe, the watchdog's
   rebuild (every graph re-captured), byte-equal answers, the recovery
   seconds, and ``torch.cuda.memory_allocated()`` after the recovery no
   more than one engine's weights over its value before the poison, with
   the same number of live ``CompiledModel`` objects; (6) ``/admin/drain``
   with a stream in flight: the stream finishes whole, a new ``:predict``
   and ``/healthz`` answer 503; (7) ``/metrics?format=prometheus`` against
   ``tools/metrics_manifest.json`` through ``tools/check_metrics.py``.
   (Check 5, the prefix chaos, runs in phase 13's paged engine.)
15. residency: one server with BERT-base int8 PINNED at (1, 8) x 128, GPT-2
   small int8 lazy (its 8-slot ``:generate`` lane, ``:predict`` at (1,) x 64)
   and ResNet-50 bf16 lazy at (1, 8), seed weights at full width, over a
   checkpoint store in a temporary directory; (1) only BERT builds at boot
   (``memory_allocated`` within its ledger entry plus the runner's
   overhead), eight concurrent cold ResNet-50 requests make one activation
   and answer byte-equal to a ResNet-50 built eagerly in the process;
   (2) a GPT-2 request with ``X-Deadline-Ms`` below the activation estimate
   answers 503 ``cold_start`` with ``Retry-After`` and launches nothing;
   (3) with ``hbm_budget_bytes`` set so that BERT and either lazy model fit
   but not all three, the GPT-2 activation that request started demotes
   ResNet-50 to the host (freeing its weights and graph pool, measured on
   the dispatch thread), never the pinned BERT, which answers 200 BERT
   requests sent meanwhile, byte-equal (their p50/p99 printed); (4)
   ResNet-50 restored from the host answers byte-equal through new
   captures (one a bucket); (5) GPT-2 demoted to the disk tier and
   streamed back answers ``:predict`` and a greedy ``:generate`` stream
   byte-equal, and again with a torn chunk on every read (degraded to the
   full rebuild); (6) GPT-2 from none streams its stored weights while it
   builds and captures, copied in place before the first replay,
   byte-equal; (7) two host and disk cycles of each lazy model leave
   ``memory_allocated`` within 8 MiB and the live ``CompiledModel`` count
   as they were, the host tier's bytes those of its pinned copies; (8) the
   idle reaper takes ResNet-50 to the host, then (a store being set) to
   disk, and a request brings it back; (9) ``/metrics?format=prometheus``
   with the residency and store families against the manifest.  Every
   ``int8_matmul`` launch of the phase ran in a captured graph's warm-up
   or replay;
16. the request plane: one server with BERT-base int8 (1, 8) x 128,
   ResNet-50 bf16 (1, 8) and GPT-2 small int8 on an 8-slot ``:generate``
   lane, seed weights at full width.  (1) The same instances over the JSON
   lane and the binary tensor lane (``serving/wire.py``), single and 8 at
   once: predictions byte-decode equal, the client p50 of each lane
   printed; a truncated frame 400 with both ids, a declared oversize 413,
   the lane off 415; every ``int8_matmul`` launch in a graph's replay.  (2)
   Every work answer carries ``X-Request-Id`` (a given one echoed) and
   ``X-Trace-Id``, a ``traceparent`` joins its trace, ``GET
   /admin/trace/{id}`` of a BERT request holds admission, queue,
   batch_form, device (equal to ``X-Device-Ms``) with the exec span inside
   it, and respond, under a root no shorter than that chain; a GPT-2
   stream's ``X-Stream-Id`` is its request id; a 400 carries both ids.  (3)
   ``POST /admin/profile`` over BERT traffic names ``int8_matmul``'s kernel,
   a second capture meanwhile answers 409, and ResNet-50 restored from the
   host tier while the profile is open captures and answers byte-equal;
   ``/metrics`` with exemplars against the manifest.  (4) The kill -9 test
   (``tools/crashtest.py``) with SD-1.5 at 512x512, 20 steps (booted from
   phase 22a's staged tree): four
   journaled jobs, a SIGKILL with a backlog, the restart: none lost, every
   resubmit deduped, a recovered job's PNG byte-equal to the same payload
   run fresh (boot seconds, ``replay_ms``, job seconds and flash launches
   of both server processes printed).  (5) Runs on phase 6's engine: SD's
   prepare and finalize graphs against eager, bitwise, no kernel launched,
   and a job's seconds with them captured and eager.

17. stream mobility and speculation on the paged lane: one server with
   GPT-2 small int8 on the paged pool (16-token pages, 64-token chunks, 8
   slots, 32 new tokens) as ``gpt2`` with ``spec_draft: gpt2_draft`` (GPT-2
   small bf16 from the same seed, k = 4), as ``gpt2_plain`` without
   speculation, and as ``gpt2_swap`` on a pool of 12 pages of 16 and the
   trash page.  (1) The same 8 SSE streams (4 greedy, 4 sampled) with
   speculation on and off: greedy streams under the margin rule
   at the verify's 40 rows, sampled ones replayed tick by tick (the
   rejection sampling of ``speculative_verify_core`` on the target's and
   the draft's teacher-forced logits with the lane's draws, every verdict
   and draw under the margin rule), on against off parting only at
   undecided positions, the acceptance rate, fallback ticks and tokens/s
   printed; then 8 of them with ``spec_mismatch`` on every tick (almost
   nothing accepted, the same rules, the residual mass at each rejection
   printed).  (2) Four swap-lane streams
   alone, then together: they swap to host (``pressure`` migrations, no
   eviction) and each equals its run alone byte for byte; with a
   ``migration`` drop on every swap they evict instead and still finish.
   (3) Two ``cli serve`` processes (``tools/streammove.py``): a stream moved
   mid-decode by snapshot, cutover, import, commit and attach, byte-equal to
   the source's control with no token lost or repeated; moved again with its
   prompt pages deduped; a corrupt page caught and fetched again; a drop
   503 with Retry-After, and an abort resuming in place.  (4) The draft
   demoted to the host tier: the target decodes plain with no error; the
   draft restored: its graphs captured again and speculation back.
   ``int8_matmul``'s launches exactly the lanes' graph runs (49 a verify,
   at M = 40, which phase 3 holds against the plain version), plus the two
   server processes' from their ``/metrics``;
18. multi-tenant adapters and the regime-routed lane, GPT-2 small at full
   width from its seed.  (a) ``gpt2``, bf16 with ``adapter_slots`` 4 at
   rank 8 on q and v, three tenants from seeds (the smallest alpha of
   ``LORA_ALPHAS`` that parts each tenant's greedy tokens from the base's,
   printed), the paged lane, :predict buckets (1, 4, 8) x 64, beside
   ``gpt2_base`` (no pool).  (1) Three tenants and the base in one
   coalescing window: co-batched (``multi_adapter_batches``), each row
   byte-equal to its masked run (the others at slot 0) in the same bucket,
   the base's to ``gpt2_base``, and each under the margin rule against it
   alone at bucket 1.  (2) 8 SSE streams (two a tenant, two base) under the
   margin rule against the fixed route with their adapter; the rates of 8
   adapter streams and 8 base streams.  (3) Three detach and re-attach
   cycles of one tenant: no graph captured, the detached slot replays the
   base's bytes, the tenant's bytes come back, ``memory_allocated`` within
   1 MiB; a deadline below the attach estimate answers 503
   ``adapter_cold`` with Retry-After and dispatches nothing.  (4) An
   ``adapter`` fault fails one tenant's attach (503); the base and the
   other tenants answer byte-equal.  (5) ``/metrics`` with the adapter
   families against the manifest.  No kernel of the port runs on this
   lane.  (b) ``gpt2_auto`` (``params_dtype: auto``, crossover 4, a paged
   lane of 4 slots) beside ``gpt2_int8`` and ``gpt2_bf16``: bucket 8
   byte-equal to ``gpt2_bf16``'s with no ``int8_matmul``; buckets 1 and 4
   byte-equal to bf16 prefill followed by int8 decode composed by hand;
   exactly 49 x 24 ``int8_matmul`` launches a replay at buckets 1 and 4, and
   the served load's exactly its replays and the lane's graph runs; the
   int8 tree's ``lm_scale`` zeroed in place changes buckets 1 and 4 and not
   8, and restored gives the bytes back; the model's bytes the int8 lane's
   plus the bf16 layer weights and biases within 1 MiB, one address a
   tensor; the lane's streams under the margin rule.  Printed: attach ms,
   a bucket-4 call with adapters against the adapter-free model,
   tokens/s, a generate call per bucket for ``auto``, ``int8`` and bf16;
19. the tenancy and control planes (``serving/variants.py``, ``slo.py``,
   ``autoscale.py``): the family ``gpt2x`` of GPT-2 small bf16 (rank 2,
   ``spec_draft: "auto"``, k = 4) and int8 (rank 1), paged lanes of 8 slots
   and 16-token pages, :predict buckets (1, 4, 8) x 64, 32 new tokens, and a
   pinned bf16 ``gpt2_probe`` at (1,) x 16, seed weights at full width.
   (1) A family :predict answers ``X-Served-Variant: gpt2_bf16`` with
   gpt2_bf16's own answer, ``prefer_cost`` gpt2_int8's, exactly 2 x 49 x 33
   ``int8_matmul`` launches for the two int8 calls; ``min_quality`` above
   the ladder sheds 429 with the family's minimum Retry-After.  (2) A
   latency rule on gpt2_bf16 breaks a 100 ms objective: family :predict and
   a family :generate stream are served by gpt2_int8, degraded, the
   brownout gauge 1; the rule cleared, the family leaves after its exit
   ticks and its hold, each transition counted once; the selection's p50
   and p99 over 2000 on the server's loop.  (3) The auto draft: 8 greedy
   streams with ``X-Spec-Draft: gpt2_int8`` and with the draft demoted to
   the host (plain decode), both under the margin rule, the acceptance rate
   and tokens/s on and off.  (4) ``/admin/slo``'s outcomes as the client
   saw them, an ``error`` burst flipping the fast alarm on ``/healthz``
   (health 200), the usage ledger's device ms against ``X-Device-Ms``, a
   stream pair's page-seconds and prefix tokens.  (5) The autoscaler: the
   host-tier restores measured, then periodic arrivals at gpt2_bf16 demoted
   until the history is in and warm after; both rungs demoted and pre-warmed
   before the predicted arrival (causes ``prewarm`` and ``prewarm_draft``,
   no activation wait on its trace), gpt2_probe's latency beside it;
   ``starve`` dropping the plane to reactive and ``spike`` arrivals never
   journaled.  (6) ``/metrics`` with the planes' families against the
   manifest.  (7) Every ``int8_matmul`` launch of the phase in a captured
   graph's warm-up or replay;
20. the host ingest planes (``serving/perfplane.py``, ``acceptors.py``,
   ``acceptor_telemetry.py``): one server with BERT-base int8 (1, 8) x 128
   (its ``flops_per_sample`` from its shapes) and ResNet-50 bf16 (1, 8),
   seed weights at full width, two ``SO_REUSEPORT`` acceptor workers on
   shared-memory rings sized to ``/dev/shm``, the perf plane on.  (1) 24
   single and 4 8-instance frames a model, one at a time, to the ingest
   port and to the main port: the answers byte-decode equal; at the worker
   a declared oversize 413, a truncated frame 400, a JSON body 415,
   ``X-Deadline-MS: 1`` behind a slow dispatch 504, each with both ids.
   (2) ``int8_matmul`` on the fast lane exactly 72 x the BERT forwards the
   runner counted there, every one in a replay.  (3) Both workers alive and
   accepting; no worker maps libtorch.  (4) A fast-lane BERT trace joins a
   given ``traceparent``: sock_read, frame_validate, ring_wait,
   binary_decode, admission, queue, batch_form, device (exec inside),
   respond.  (5) ``kill -9`` of a worker with 4 requests in flight: each
   answered, ``worker_up`` 0 then 1, ``restarts_total`` 1, check 1's frames
   byte-equal after the respawn; a demoted ResNet-50 answers 503
   ``cold_start`` on the fast lane, and the loop lag over its restore is
   printed.  (6) ``/admin/perf``: every stage of check 1 with the count of
   requests each lane sent, the loop-lag histogram, the dispatch thread in
   the stack table, BERT's gauges with ``mfu_pct`` its own arithmetic
   against the card's peak; ``cli perf`` renders it.  (7) ``/metrics`` with
   the host planes' families against the manifest.  Printed: the client
   p50/p99 of each lane, the stage p50s, the loop lag, the workers' spawn
   seconds, the host's machine and ``/dev/shm``;
21. the fleet router (``serving/fleet.py``) in front of ``cli serve``
   replicas on the one card, the kernels built before any replica starts.
   ``cli fleet --spawn 2`` with BERT-base int8 (1, 8) x 128 and GPT-2 small
   int8 on the paged lane (16-token pages, 8 slots), seed weights, the
   journal on.  (1) Both replicas healthy; 16 BERT predicts through the
   router equal to the same requests sent to the replica directly, 4 GPT-2
   streams equal to the same prompts sent to the other replica (its prefix
   cache cold), exactly 72 ``int8_matmul`` launches a BERT forward on
   the replicas' ``/metrics``; a routed request's trace on the replica under
   the router's span; the router's and the direct client p50/p99 and
   ``tpuserve_fleet_router_ms``.  (2) A partition of the replica the router
   picks: answered by the peer in 2 attempts, quarantined, readmitted once
   cleared; r0's forecast raised by a 20 ms replica rule, then
   ``slow_replica`` on r1: every pick r1, the least forecast wait, its
   answers late; a ``cold_start`` spill onto a replica whose
   GPT-2 was unloaded activates it in the background while the router keeps
   it healthy and its ``/healthz`` names the hold; drain stops routing and
   terminates the replica, a restart and undrain restore it; the router's
   Prometheus text against the manifest.  (3), (4) and (5) at once, each the
   package's crash test (``tools/crashtest.py``): the fleet kill -9 test
   (BERT-base int8 ``:submit`` jobs behind a 600 ms rule; predicts answered
   in at most 2 attempts, the dead owner's job poll, quarantine, readmission
   after a restart on its journal, every acknowledged job done and every
   resubmit deduped), the variant
   kill -9 test (ResNet-18 rungs at 64 px; family predicts answered
   degraded by ``rn_lite``) and the disaggregated kill -9 test (three GPT-2
   small int8 paged replicas, r0 prefill; the killed decode replica's stream
   resumed on the third, its tokens equal to the undisturbed stream and to
   the same prompt on one replica, else held under the margin rule).
   Printed: boot seconds and device memory of each replica, the router's
   overhead, partition-to-peer ms, quarantine and readmission seconds, the
   cutover and kill-to-resume ms, each replica process's ``int8_matmul``
   launches (summed into the kernels line), the phase's seconds;
22. the deploy path, in two parts.  22a runs right after phase 3:
   ``cli deploy`` in a subprocess with a JSON config of BERT-base int8 and
   SD-1.5 (the file set; its ``config.json`` loads back equal); a
   full-width diffusers-layout SD-1.5 directory written from
   ``init_sd15_params(0)`` by ``tests/sd_diffusers.py`` through the port's
   safetensors writer; ``cli stage`` in a subprocess of BERT-base int8 (1,
   8) x 128 with its labels as a list and SD-1.5 512², 20 steps, from that
   directory: the staged SD-1.5 tree byte-equal to the seeded one, the
   staged BERT tree the port's seeded float tree with no ``kernel_q``, the
   seconds and bytes of each.  Phases 6 and 16 then boot SD-1.5 from that
   staged tree (the seeded tree's bytes) rather than drawing the seeded
   init again.  22b runs last: an engine built from the staged
   ``config.json``: phase 4's BERT bodies answered byte-equal to phase 4's
   answers (phase 4 serves seeded weights), phase 6's first job's PNG
   byte-equal to phase 6's, exactly 72 ``int8_matmul`` launches a BERT
   forward and 10 ``flash_attention`` a UNet call (both in the kernels
   line); the phase's seconds, and every phase's at the end;

With ``--profile``, every path is also profiled eager against replayed:
device-busy and wall time, the idle share, and the host's calls, where a
replay must issue one ``cudaGraphLaunch`` a forward, chunk, generate call
or step and no kernel launch.  Each path prints its device memory peak.

Every kernel count is set to 0 just before each path and read just after.
A count is of device executions: an eager run counts, a graph's capture
counts nothing, and each replay adds the launches the graph holds.
The line before the last is ``{"kernels": [...]}`` with each kernel's
launches on its main path, error against its plain version, and per-call
times (kernel, plain version, one PyTorch library call) beside its bound;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import dataclasses
import gc
import importlib.util
import io
import json
import math
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import weakref
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# Data-sheet peaks of the H100 SXM at its full 700 W power limit (dense).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Exponentials: 16 special-function results per SM per clock (compute
# capability 9.0), 132 SMs, at 1.83 GHz.
PEAK_EXP_PER_S = 132 * 16 * 1.83e9

BERT = {"layers": 12, "seq": 128, "batch_buckets": (1, 8)}
# (K, N) of the six encoder projections of one layer: query, key, value,
# attention_output, intermediate, output.
LAYER_PROJECTIONS = [(768, 768)] * 4 + [(768, 3072), (3072, 768)]
MAIN_M = (128, 1024)  # the (1, 128) and (8, 128) buckets
RAGGED = [(3, 100, 50), (1, 768, 768)]
# GPT-2 small's int8 products: (K, N) of the four layer projections (q|k|v
# fused, out, fc1, fc2) at decode (M = 1, 8) and prefill (M = 512), and the
# padded lm head with f32 logits at decode.
GPT2_KN = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]
GPT2_HEAD = (768, 50304)
GPT2_DECODE_M = (1, 8)
GPT2_PREFILL_M = 512
# Whisper-tiny's int8 decoder products: (K, N) of q/k/v/out/cq/cout, fc1 and
# fc2 at decode (M = B: 1, 4) and the prompt's prefill (M = 4B: 4, 16); the
# padded lm head with f32 logits at M = B.  At K = 384 the split-K plans
# give each cluster rank one 64-wide K tile.
WHISPER_KN = [(384, 384), (384, 1536), (1536, 384)]
WHISPER_HEAD = (384, 51968)
WHISPER_M = (1, 4, 16)
WHISPER_PROMPT = 4  # the default task prompt: sot, language, task, no-timestamps
DTYPES = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
          (torch.float32, torch.float32)]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# -- phase 1: device ---------------------------------------------------------

def phase_device() -> str:
    """Check for the card; returns its name and power limit as nvidia-smi
    gives them, for the lines that report a number."""
    check(torch.cuda.is_available(), "CUDA is not available: chip_smoke needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    # f32 products in full f32: the plain versions are the reference.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# -- phase 2: build ----------------------------------------------------------

def phase_build() -> None:
    from pytorch_zappa_serverless_tpu_torch.ops import flash_attention as FA
    from pytorch_zappa_serverless_tpu_torch.ops import fused_decode as FD
    from pytorch_zappa_serverless_tpu_torch.ops import int8_matmul as I

    def build(name, fn):
        t0 = time.perf_counter()
        fn()
        return name, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        futs = [pool.submit(build, "int8_matmul.cu", I._kernel_lib),
                pool.submit(build, "flash_attention.cu", FA._kernel_lib),
                pool.submit(build, "fused_decode.cu", FD._kernel_lib)]
        for f in futs:
            name, secs = f.result()
            log(f"build {name}: {secs:.3f} s")
    log(f"build, all three sources in parallel: {time.perf_counter() - t0:.3f} s")


# -- phase 3: kernels against their plain versions ---------------------------

def time_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    by CUDA events, after a warm-up.  The operands stay in L2 between calls.
    Where a call is shorter than its host time this times the host: the
    kernels are timed with ``launch_ms``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def matmul_bytes_ops(m: int, k: int, n: int, x_dtype, out_dtype) -> tuple[int, int]:
    """(bytes, operations) of the W8A16 product: each input read once, the
    output written once; 2·M·K·N operations."""
    xb = torch.empty(0, dtype=x_dtype).element_size()
    ob = torch.empty(0, dtype=out_dtype).element_size()
    return m * k * xb + k * n + 4 * n + m * n * ob, 2 * m * k * n


def matmul_bound(m: int, k: int, n: int, x_dtype, out_dtype) -> tuple[float, float]:
    """(operations ms, bytes ms) of the W8A16 product: the operations at the
    peak rate of the input type (bf16 tensor cores, or f32 CUDA cores), the
    bytes at the memory rate.  The least time the card could take is the
    larger of the two."""
    nbytes, ops = matmul_bytes_ops(m, k, n, x_dtype, out_dtype)
    peak = PEAK_BF16_FLOPS if x_dtype == torch.bfloat16 else PEAK_F32_FLOPS
    return 1e3 * ops / peak, 1e3 * nbytes / PEAK_BYTES_PER_S


def int8_cases() -> list[tuple]:
    """(M, K, N, x dtype, out dtype, timed) of every kernel check: the BERT
    shapes and the ragged ones in the three dtype pairs, the GPT-2 and
    Whisper shapes in the served ones; the served dtype pair of the BERT
    buckets, of GPT-2 decode at M = 8 and of Whisper at M = 4 is timed."""
    cases = []
    for m in MAIN_M:
        for k, n in sorted(set(LAYER_PROJECTIONS)):
            cases += [(m, k, n, xd, od, (xd, od) == DTYPES[0]) for xd, od in DTYPES]
    cases += [(m, k, n, xd, od, False) for m, k, n in RAGGED for xd, od in DTYPES]
    for m in GPT2_DECODE_M + (GPT2_PREFILL_M,):
        cases += [(m, k, n, *DTYPES[0], m == 8) for k, n in GPT2_KN]
    cases += [(m, *GPT2_HEAD, *DTYPES[1], m == 8) for m in GPT2_DECODE_M]
    cases += [(m, k, n, *DTYPES[0], m == 4) for m in WHISPER_M for k, n in WHISPER_KN]
    cases += [(m, *WHISPER_HEAD, *DTYPES[1], m == 4) for m in WHISPER_M[:2]]
    return cases + generate_int8_cases()


def generate_int8_cases() -> list[tuple]:
    """The int8 products phase 13's lanes add, from ``GEN`` and
    ``GEN_WHISPER``: the GPT-2 slot lane's prefill graphs, one per (prompt
    bucket, power-of-two admission batch B), run the layer projections at
    M = B x bucket and the lm head at M = B; Whisper's lane prefill runs
    its decoder projections over the task prompt at M = 4B and its head at
    M = B.  The segments run at the pool's rows (GPT-2 8, Whisper 4),
    which the cases above hold.  Row counts those cases hold already are
    left out.  Phase 17 adds the verify forward's M = S x (k + 1) = 40
    (its paged chunks' M = G x C lie among the prefill rows)."""
    pow2 = lambda n: [1 << i for i in range(n.bit_length())]  # noqa: E731
    gpt2_b, whisper_b = pow2(GEN["gen_slots"]), pow2(GEN_WHISPER["gen_slots"])
    held = set(GPT2_DECODE_M + (GPT2_PREFILL_M,))
    gen_m = sorted({b * p for b in gpt2_b for p in GEN["seq_buckets"]} - held)
    cases = [(m, k, n, *DTYPES[0], False) for m in gen_m for k, n in GPT2_KN]
    cases += [(m, *GPT2_HEAD, *DTYPES[1], False) for m in gpt2_b if m not in GPT2_DECODE_M]
    whisper_m = sorted({WHISPER_PROMPT * b for b in whisper_b} - set(WHISPER_M))
    cases += [(m, k, n, *DTYPES[0], False) for m in whisper_m for k, n in WHISPER_KN]
    cases += [(m, *WHISPER_HEAD, *DTYPES[1], False) for m in whisper_b
              if m not in WHISPER_M[:2]]
    # Phase 17's speculative verify runs the projections and the head at
    # S x (k + 1) rows, timed: a verify forward's share of the product.
    cases += [(SPEC_M, k, n, *DTYPES[0], True) for k, n in GPT2_KN]
    cases += [(SPEC_M, *GPT2_HEAD, *DTYPES[1], True)]
    # Phase 18's regime-routed lane decodes on the int8 tree at its buckets
    # up to the crossover (1, 4) and at its lane's 4 slots; the head at M = 4
    # is among the lane prefills' above.
    cases += [(AUTO["crossover"], k, n, *DTYPES[0], False) for k, n in GPT2_KN]
    return cases


def phase_kernels() -> dict:
    from pytorch_zappa_serverless_tpu_torch.ops import int8_matmul as I

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    max_err, timings = 0.0, {}
    for m, k, n, x_dtype, out_dtype, timed in int8_cases():
        x32 = torch.randn(m, k, device=dev, generator=g) * 0.5
        w_q = torch.randint(-127, 128, (k, n), device=dev, generator=g, dtype=torch.int8)
        scale = torch.rand(n, device=dev, generator=g) * 2e-3 + 1e-4
        x = x32.to(x_dtype)
        y = I.int8_matmul(x, w_q, scale, out_dtype=out_dtype)
        torch.cuda.synchronize()
        want = I.int8_matmul_reference(x, w_q, scale, out_dtype)
        tag = f"int8_matmul {m}x{k}x{n} {str(x_dtype)[6:]}->{str(out_dtype)[6:]}"
        check(y.shape == want.shape and y.dtype == want.dtype,
              f"{tag}: {y.shape} {y.dtype} vs {want.shape} {want.dtype}")
        check(bool(torch.isfinite(y).all()), f"{tag}: non-finite output")
        err = (y.float() - want.float()).abs().max().item()
        if out_dtype == torch.bfloat16:
            ok = torch.allclose(y.float(), want.float(), rtol=2e-2, atol=2e-2)
            tol = "rtol=atol=2e-2"
        else:
            atol = 1e-3 * want.abs().max().item()
            ok, tol = err <= atol, f"atol={atol:.3g}"
        check(ok, f"{tag}: max |err| {err} outside {tol}")
        max_err = max(max_err, err)
        log(f"{tag} (plan {tuple(I.plan(m, k, n))}): max |err| {err:.3g} ({tol}) ok")
        if not timed:
            continue
        w_deq = (w_q.float() * scale).to(torch.bfloat16)
        library = (lambda: torch.matmul(x, w_deq)) if out_dtype == torch.bfloat16 else \
            (lambda: torch.matmul(x, w_deq).float())
        row = {"ms": launch_ms(lambda: I.int8_matmul(x, w_q, scale, out_dtype=out_dtype)),
               "plain_ms": time_ms(lambda: I.int8_matmul_reference(x, w_q, scale, out_dtype)),
               "library_ms": launch_ms(library)}
        row["ops_ms"], row["bytes_ms"] = matmul_bound(m, k, n, x_dtype, out_dtype)
        row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
        row["bound_by"] = "operations" if row["ops_ms"] >= row["bytes_ms"] else "bytes"
        timings[m, k, n] = row
        log(f"time int8_matmul M={m} K={k} N={n}: kernel {row['ms']:.5f} ms, "
            f"plain {row['plain_ms']:.4f} ms, cuBLAS bf16 on dequantised weights "
            f"{row['library_ms']:.5f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}; {row['bound_ms'] / row['ms']:.3f} of the kernel's time)")
    # Split-K sums in fixed rank order: two launches agree bit for bit (GPT-2's
    # shape, and Whisper's, one K tile on each of six ranks).
    for m, k, n in ((8, 768, 768), (4, 384, 384)):
        check(I.plan(m, k, n).splits > 1, f"{m}x{k}x{n} is not a split-K shape")
        x = (torch.randn(m, k, device=dev, generator=g) * 0.5).bfloat16()
        w_q = torch.randint(-127, 128, (k, n), device=dev, generator=g, dtype=torch.int8)
        scale = torch.rand(n, device=dev, generator=g) * 2e-3 + 1e-4
        runs = [I.int8_matmul(x, w_q, scale) for _ in range(2)]
        check(torch.equal(*runs), f"int8_matmul {m}x{k}x{n}: two split-K launches differ")
        log(f"int8_matmul {m}x{k}x{n} (plan {tuple(I.plan(m, k, n))}): two launches bitwise "
            f"equal")
    return {"max_abs_err": max_err, "timings": timings, "work": phase_int8_work()}


def phase_int8_work() -> dict:
    """Whole pieces of main-path work over distinct weights, so that they
    stream from device memory as served: one GPT-2 small position step at
    M = 8 (48 layer projections + the f32 lm head, 123.6 MB of int8), one
    BERT-base (8, 128) forward (72 projections at M = 1024) and one
    Whisper-tiny decoder position at M = 4 (32 projections + the f32 lm
    head, 28.2 MB of int8).  Kernel, plain version and cuBLAS on the
    dequantised bf16 weights by ``device_ms``; the bound is the step's
    bytes, or the forward's operations, at the card's peak."""
    from pytorch_zappa_serverless_tpu_torch.ops import int8_matmul as I
    from pytorch_zappa_serverless_tpu_torch.tools import int8_ablation as IA

    g = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for name, m in IA.WORK.items():
        ops = IA.operands(name, g)
        nbytes = opcount = 0
        for k, n, out_dtype in IA.products(name):
            b, o = matmul_bytes_ops(m, k, n, torch.bfloat16, out_dtype)
            nbytes, opcount = nbytes + b, opcount + o
        b_ms, o_ms = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * opcount / PEAK_BF16_FLOPS
        row = {"ms": device_ms(IA.run_kernel(ops)), "library_ms": device_ms(IA.run_cublas(ops)),
               "plain_ms": device_ms(lambda: [I.int8_matmul_reference(x, w, s, o)
                                              for x, w, s, o, _ in ops]),
               "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
               "launches": len(ops), "weight_mb": sum(op[1].numel() for op in ops) / 1e6}
        out[name] = row
        log(f"time int8_matmul {name} ({row['launches']} launches at M={m}, "
            f"{row['weight_mb']:.1f} MB of distinct int8 weights): kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, cuBLAS on dequantised bf16 "
            f"{row['library_ms']:.4f} ms "
            f"({row['ms'] / row['library_ms']:.3f} x), bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}; {row['bound_ms'] / row['ms']:.3f} of the kernel's time)")
        del ops
    return out


def per_verify(timings: dict) -> dict:
    """One speculative verify forward's int8_matmul at M = ``SPEC_M`` from
    the per-shape rows: GPT-2 small's 12 layers of four projections and the
    f32 lm head.  The bound is the sum of the launches' bounds; it names
    what bounds most of it."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms")
    out = {key: 12 * sum(timings[SPEC_M, k, n][key] for k, n in GPT2_KN)
           + timings[(SPEC_M, *GPT2_HEAD)][key] for key in keys}
    out["bound_by"] = "operations" if out.pop("ops_ms") >= out.pop("bytes_ms") else "bytes"
    return out


def per_forward(timings: dict, m: int) -> dict:
    """One forward's worth of int8_matmul at row count ``m`` from the
    per-shape rows (operands warm in L2): the layer's six projections times
    the number of layers.  The bound is the sum of the launches' bounds; it
    names what bounds most of it."""
    out = {key: BERT["layers"] * sum(timings[m, k, n][key] for k, n in LAYER_PROJECTIONS)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms")}
    out["bound_by"] = "operations" if out.pop("ops_ms") >= out.pop("bytes_ms") else "bytes"
    return out


# Flash attention at the SD-1.5 path's shapes: [B, T, H, D] with the CFG
# batch of 2 and 8 heads; five launches per UNet call at each.
FLASH_MAIN = [(2, 4096, 8, 40), (2, 1024, 8, 80)]
FLASH_PER_UNET = {(2, 4096, 8, 40): 5, (2, 1024, 8, 80): 5}
# (B, Tq, Tk, H, D, dtype, causal, masked): the edge cases the kernel takes.
FLASH_EDGES = [(1, 1024, 1024, 8, 64, torch.bfloat16, False, False),
               (2, 1000, 1000, 8, 40, torch.bfloat16, False, False),   # ragged T
               (2, 1024, 1024, 8, 40, torch.bfloat16, False, True),    # kv_mask
               (1, 1024, 1024, 8, 40, torch.bfloat16, True, False),    # causal
               (2, 1024, 1024, 8, 160, torch.bfloat16, False, False),  # 1024x1024 images
               (2, 1000, 1000, 4, 80, torch.float32, False, True),     # f32, ragged
               (2, 100, 100, 8, 40, torch.bfloat16, False, False),     # Tq < one Q tile
               (1, 256, 130, 8, 64, torch.bfloat16, False, False),     # 128 keys + 2
               (1, 256, 256, 8, 64, torch.bfloat16, True, False),      # causal, 128-row tiles
               (2, 1024, 1024, 8, 20, torch.bfloat16, False, False)]   # D = 20: padded copy


# Kernel vs plain version, per element |y - want| <= atol + rtol·|want|.
# bf16: rtol = 2^-6 is two bf16 roundings at the bottom of a binade (each
# side rounds its f32 output once); atol = 2e-3 covers outputs near 0, where
# P rounded to bf16 against a running rather than the final max is what
# differs.  At [2,4096,8,40] the outputs' typical |y| is ~0.02, so the limit
# there is ~2.3e-3, and a kernel that took sm_scale from a padded D
# (1/sqrt(48)) is off by ~2.4e-3 on average: phase_flash checks that it
# fails.  f32: the special-function exponential and per-tile sums.
FLASH_TOL = {torch.bfloat16: (2e-3, 2 ** -6), torch.float32: (1e-4, 1e-4)}


def tol_share(y: torch.Tensor, want: torch.Tensor, atol: float, rtol: float) -> float:
    """Largest |y - want| / (atol + rtol·|want|): at most 1 within tolerance."""
    y, want = y.float(), want.float()
    return ((y - want).abs() / (atol + rtol * want.abs())).max().item()


def flash_bound(b: int, t: int, h: int, d: int) -> dict:
    """Least time of one launch at [b, t, h, d] bf16 self-attention: the
    largest of the two products (4·b·h·t²·d operations on the tensor cores),
    the exponentials (b·h·t² on the special-function units) and the bytes (q,
    k, v read once, o written once)."""
    parts = {"products": 1e3 * 4 * b * h * t * t * d / PEAK_BF16_FLOPS,
             "exponentials": 1e3 * b * h * t * t / PEAK_EXP_PER_S,
             "bytes": 1e3 * 4 * b * t * h * d * 2 / PEAK_BYTES_PER_S}
    worst = max(parts, key=parts.get)
    return {"bound_ms": parts[worst], "bound_detail": worst,
            "bound_by": "bytes" if worst == "bytes" else "operations"}


def launch_ms(fn, n: int = 10) -> float:
    """Device time of one of ``n`` back-to-back launches of ``fn``, queued
    behind a spin kernel (``device_ms``): at [2,1024,8,80] a launch is
    shorter than the wrapper's Python, so plain events would time the host."""
    return device_ms(lambda: [fn() for _ in range(n)]) / n


def phase_flash() -> dict:
    """flash_attention against flash_attention_reference on the card, within
    ``FLASH_TOL``; at [2,4096,8,40] also a planted fault (sm_scale of a
    padded D) that the tolerance must reject."""
    import torch.nn.functional as F

    from pytorch_zappa_serverless_tpu_torch.ops import flash_attention as FA

    g = torch.Generator(device="cuda").manual_seed(1)
    dev = torch.device("cuda")
    max_err, timings = 0.0, {}
    cases = [(b, t, t, h, d, torch.bfloat16, False, False) for b, t, h, d in FLASH_MAIN]
    for b, tq, tk, h, d, dtype, causal, masked in cases + FLASH_EDGES:
        q, k, v = (torch.randn(b, t, h, d, device=dev, generator=g).to(dtype)
                   for t in (tq, tk, tk))
        mask = None
        if masked:  # batch row 0 attends to all but 100 keys, row 1 to none
            mask = torch.zeros(b, tk, dtype=torch.bool, device=dev)
            mask[0, : tk - 100] = True
        y = FA.flash_attention(q, k, v, causal=causal, kv_mask=mask)
        torch.cuda.synchronize()
        want = FA.flash_attention_reference(q, k, v, causal=causal, kv_mask=mask)
        tag = f"flash_attention [{b},{tq},{h},{d}]{'x' + str(tk) if tk != tq else ''} " \
              f"{str(dtype)[6:]}{' causal' if causal else ''}{' kv_mask' if masked else ''}"
        check(y.shape == want.shape and y.dtype == want.dtype, f"{tag}: {y.shape} {y.dtype}")
        check(bool(torch.isfinite(y).all()), f"{tag}: non-finite output")
        atol, rtol = FLASH_TOL[dtype]
        err = (y.float() - want.float()).abs().max().item()
        share = tol_share(y, want, atol, rtol)
        check(share <= 1, f"{tag}: max |err| {err}, {share:.3g} x the tolerance "
                          f"(atol={atol}, rtol={rtol})")
        if masked:  # the fully masked row: uniform over the keys, finite
            uniform = v[1].float().mean(0).expand_as(y[1])
            check(tol_share(y[1], uniform, atol, rtol) <= 1,
                  f"{tag}: fully masked row is not uniform")
        max_err = max(max_err, err)
        log(f"{tag}: max |err| {err:.3g}, {share:.3f} x the tolerance (atol={atol}, "
            f"rtol={rtol:.4g}) ok")
        if (b, tq, h, d) not in FLASH_MAIN or tq != tk or causal or masked:
            continue
        if d == 40:  # the planted fault: the scale of D padded to 48
            bad = tol_share(FA.flash_attention(q, k, v, sm_scale=48 ** -0.5), want, atol, rtol)
            check(bad > 1, f"{tag}: the tolerance passes sm_scale = 1/sqrt(48) ({bad:.3g} x)")
            log(f"{tag}: sm_scale from the padded D (1/sqrt(48)) is {bad:.3f} x the "
                f"tolerance: rejected, as it must be")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row = {"ms": launch_ms(lambda: FA.flash_attention(q, k, v)),
               "plain_ms": time_ms(lambda: FA.flash_attention_reference(q, k, v), reps=5),
               "library_ms": launch_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
               **flash_bound(b, tq, h, d)}
        timings[b, tq, h, d] = row
        log(f"time flash_attention [{b},{tq},{h},{d}] bf16: kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms "
            f"({row['ms'] / row['library_ms']:.3f} x), bound {row['bound_ms']:.5f} ms "
            f"({row['bound_detail']}; {row['bound_ms'] / row['ms']:.3f} of the kernel's time)")
    return {"max_abs_err": max_err, "timings": timings}


def per_unet_call(timings: dict) -> dict:
    """One UNet call's ten flash launches at 512x512.  The bound is the sum
    of the launches' bounds; it names what bounds most of it."""
    out = {key: sum(n * timings[shape][key] for shape, n in FLASH_PER_UNET.items())
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    detail = {}
    for shape, n in FLASH_PER_UNET.items():
        row = timings[shape]
        detail[row["bound_detail"]] = detail.get(row["bound_detail"], 0.0) + n * row["bound_ms"]
    worst = max(detail, key=detail.get)
    out["bound_by"] = "bytes" if worst == "bytes" else "operations"
    out["bound_detail"] = worst
    return out


# -- phase 4: the BERT path ----------------------------------------------------

FUSED_ENTRY_POINTS = ("fused_attn_step", "fused_attn_step_int8", "fused_mlp_step",
                      "fused_mlp_step_int8")


def reset_counts() -> None:
    """Every kernel count (and the UNet calls) to 0: just before a path.  A
    count is of device executions: an eager call counts as it runs, a
    graph's capture counts nothing, each replay adds what the graph holds
    (``ops.counters``)."""
    from pytorch_zappa_serverless_tpu_torch import models  # noqa: F401  (registers unet_apply)
    from pytorch_zappa_serverless_tpu_torch.ops import counters, fused_decode  # noqa: F401

    counters.reset()


def read_counts() -> dict:
    from pytorch_zappa_serverless_tpu_torch.ops import counters

    snap = counters.snapshot()
    snap["unet_calls"] = snap.pop("unet_apply")
    return snap


def exact_counts(counts: dict, want: dict, what: str) -> None:
    """``counts`` (from ``read_counts``) hold ``want`` exactly, every other
    count 0."""
    full = {k: want.get(k, 0) for k in counts}
    check(counts == full, f"{what}: launch counts {counts} != {full}")


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def phase_replay(engine, name: str, batches: list[tuple[str, dict]], per_call: dict) -> None:
    """Each collated batch through the bucket's captured graph against
    ``forward_eager`` on the same batch, byte for byte; the batches replayed
    in turn, twice (each replay refills the static inputs, so each must give
    its own eager result); and the launch counts of each replay exactly
    ``per_call``."""
    cm = engine.model(name)
    run = engine.runner.run_fn_sync
    eager = {tag: run(cm.forward_eager, batch) for tag, batch in batches}
    for _, batch in batches:  # every graph these batches need, captured first
        run(cm.forward, batch)
    for rnd in range(2):
        for tag, batch in batches:
            reset_counts()
            got = run(cm.forward, batch)
            exact_counts(read_counts(), per_call, f"{name} replay of {tag}")
            for key, want in eager[tag].items():
                check(same_bits(got[key], want),
                      f"{name} {tag}: replay {key} differs from eager: max |d| "
                      f"{np.abs(got[key].astype(np.float64) - want).max()}")
    log(f"{name} replay vs eager: {', '.join(tag for tag, _ in batches)}: bitwise equal, "
        f"replayed in turn twice; each replay's launches exactly {per_call}; graphs "
        f"{cm.graphs}")


def log_profiles(tag: str, unit: str, eager: dict, replay: dict, per: int = 1,
                 top: int = 10) -> None:
    """The eager and replayed windows of one path side by side (``per``
    divides the per-call numbers, e.g. into per-step ones); the replay must
    issue one graph launch per call and no kernel launch from the host."""
    for kind, p in (("eager", eager), ("replay", replay)):
        log(f"profile {tag} {kind}: wall {p['wall_ms']:.4f} ms, device busy {p['busy_ms']:.4f} "
            f"ms, idle share {p['idle_share']:.4f} per call; untraced wall "
            f"{p['wall_ms_untraced']:.4f} ms, idle share {p['idle_share_untraced']:.4f}; host "
            f"calls per call {p['host_calls']}")
    calls = replay["host_calls"]
    check(calls["cudaGraphLaunch"] == 1 and calls["kernel_launches"] == 0,
          f"profile {tag}: the replayed window issued {calls} per call, not one "
          f"cudaGraphLaunch and no kernel launch")
    busy = replay["busy_ms"] or 1.0
    for name, count, ms in replay["top"][:top]:
        log(f"profile {tag} replay: {ms / per:9.4f} ms/{unit} {100 * ms / busy:5.1f}% "
            f"x{count / per:<6.4g} {name[:90]}")


def log_memory(tag: str, engine) -> None:
    """The path's device memory: its peak since the engine build began
    (weights, warm-up runs and the captures' pool), and what is still
    allocated and reserved."""
    m = engine.models
    log(f"memory {tag}: peak allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
        f"allocated {torch.cuda.memory_allocated() / 2**20:.1f} MiB, reserved "
        f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB; weights "
        f"{sum(cm.param_nbytes() for cm in m.values()) / 2**20:.1f} MiB; graphs "
        f"{ {n: cm.graphs for n, cm in m.items()} }")


def fresh_memory() -> None:
    """Free what the last path left and reset the peak, before a path."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

def http(port: int, path: str, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_config(arch: dict | None = None, seq: int = BERT["seq"],
                 batch_buckets=BERT["batch_buckets"]):
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig

    extra = {"params_dtype": "int8", **({"arch": arch} if arch else {})}
    return ServeConfig(models=[ModelConfig(
        name="bert_base", dtype="bfloat16", seq_buckets=(seq,),
        batch_buckets=tuple(batch_buckets), extra=extra)])


def phase_main_path(cfg, device: str = "cuda") -> dict:
    """Build the engine, serve, and answer requests; returns the engine, the
    launch counts, the forwards run and the responses."""
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    reset_counts()
    t0 = time.perf_counter()
    engine = build_engine(cfg, device)
    log(f"engine ready in {time.perf_counter() - t0:.3f} s on {engine.device}: "
        f"first dispatch per bucket {engine.clock.entries}")
    words = "the service answered every request it was sent in good time".split()
    requests = [
        ("/v1/models/bert_base:predict", {"text": "a short sentence to classify"}),
        ("/v1/models/bert_base:predict", {"input_ids": [101] + list(range(2000, 2100)) + [102]}),
        ("/v1/models/bert_base:predict",
         {"instances": [{"text": " ".join(words[: 3 + i])} for i in range(8)]}),
        ("/classify", {"text": "the last request goes to the classify route"}),
    ]
    answers, gets = [], {}
    with BackgroundServer(cfg, engine) as srv:
        log(f"serving on 127.0.0.1:{srv.port}")
        for path, body in requests:
            status, out = http(srv.port, path, body)
            check(status == 200, f"{path}: status {status}: {out}")
            answers.append((path, body, out))
        launches = read_counts()  # just after the path
        for path in ("/healthz", "/v1/models", "/metrics"):
            status, out = http(srv.port, path)
            check(status == 200, f"{path}: status {status}: {out}")
            gets[path] = out
    st = engine.runner.stats["bert_base"]
    forwards = len(engine.clock.entries) + st.batches
    return {"engine": engine, "launches": launches, "forwards": forwards,
            "batches": st.batches, "answers": answers, "gets": gets}


def check_answers(run: dict, num_labels: int = 2) -> None:
    for path, body, out in run["answers"]:
        check(out.get("model") == "bert_base" and {"timing", "predictions"} <= set(out),
              f"{path}: response keys {sorted(out)}")
        preds = out["predictions"] if "instances" in body else [out["predictions"]]
        check(len(preds) == len(body.get("instances", [body])),
              f"{path}: {len(preds)} predictions")
        for pred in preds:
            probs = [s["prob"] for s in pred["scores"]]
            check(len(probs) == num_labels and all(0.0 <= p <= 1.0 for p in probs),
                  f"{path}: probabilities {probs}")
            check(abs(sum(probs) - 1.0) <= 1e-3, f"{path}: probabilities sum to {sum(probs)}")
        log(f"{path} {json.dumps(body)[:60]}...: 200, timing {out['timing']}")
    health = run["gets"]["/healthz"]
    check(health["device_ok"] is True, f"/healthz: {health}")
    check("bert_base" in run["gets"]["/v1/models"]["models"], "/v1/models misses bert_base")


# -- phase 5: parity against the plain version -------------------------------

def collate(cm, instances: list[dict], seq: int) -> tuple[tuple[int, ...], dict]:
    """(bucket, collated host batch) for request bodies, as the engine pads them."""
    from pytorch_zappa_serverless_tpu_torch.engine.compiled import default_collate

    samples = [cm.servable.preprocess(p) for p in instances]
    bucket = cm.bucket_for(len(samples), seq)
    return bucket, default_collate(samples, bucket, cm.servable.input_spec(bucket))


def phase_parity(engine, instances: list[dict], seq: int = BERT["seq"]) -> dict:
    """The served forward (kernel) vs the same module with every projection
    routed through the plain version, on the card, on one collated batch."""
    from pytorch_zappa_serverless_tpu_torch.models.bert import Int8Dense
    from pytorch_zappa_serverless_tpu_torch.ops import int8_matmul as I

    cm = engine.model("bert_base")
    bucket, batch = collate(cm, instances, seq)
    dense = [m for m in cm.servable.module.modules() if isinstance(m, Int8Dense)]

    def plain_forward():  # eager: the captured graph holds the kernel
        for m in dense:
            m.matmul = I.int8_matmul_reference
        try:
            return cm.forward_eager(batch)["probs"]
        finally:
            for m in dense:
                m.matmul = I.int8_matmul

    served = engine.runner.run_fn_sync(lambda: cm.forward(batch)["probs"])
    plain = engine.runner.run_fn_sync(plain_forward)
    check(served.shape == plain.shape == (bucket[0], 2), f"probs shape {served.shape}")
    check(bool(np.isfinite(served).all()), "served probabilities are not finite")
    n = len(instances)
    err = float(np.abs(served[:n] - plain[:n]).max())
    check(err <= 2e-2, f"served vs plain forward: max |dprob| {err} > 2e-2")
    same = bool((served[:n].argmax(-1) == plain[:n].argmax(-1)).all())
    check(same, f"served vs plain forward: argmax differs\n{served[:n]}\n{plain[:n]}")
    log(f"parity: served int8 forward vs plain-version forward on bucket {bucket}: "
        f"max |dprob| {err:.3g} (atol 2e-2), same argmax")
    return {"max_abs_prob_err": err, "dense_modules": len(dense)}


# -- phase 6: the SD-1.5 path ---------------------------------------------------

SD = {"height": 512, "width": 512, "num_steps": 20, "chunk_steps": 4}
SD_JOBS = [{"prompt": "a photograph of an astronaut riding a horse", "seed": 1},
           {"prompt": "a red fox in the snow, oil painting", "seed": 2,
            "negative_prompt": "blurry", "guidance_scale": 5.0}]


def sd_config(variant: str | None = None, checkpoint: str | None = None, **extra):
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig

    extra = {**SD, **({"variant": variant} if variant else {}), **extra}
    return ServeConfig(models=[ModelConfig(name="sd15", dtype="bfloat16", batch_buckets=(1,),
                                           checkpoint=checkpoint, extra=extra)])


def read_png(data: bytes) -> np.ndarray:
    """An 8-bit RGB PNG with filter 0 on every row (what the port writes)
    → uint8 [H, W, 3], with zlib alone."""
    check(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG signature")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        check(struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
              == zlib.crc32(tag + body) & 0xFFFFFFFF, f"PNG {tag!r} chunk CRC")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    check(header is not None and header[2:5] == (8, 2, 0), f"PNG header {header}")
    w, h = header[:2]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    check(raw.size == h * (1 + 3 * w), f"PNG data {raw.size} bytes for {w}x{h}")
    rows = raw.reshape(h, 1 + 3 * w)
    check(not rows[:, 0].any(), "PNG rows use a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def phase_sd_path(cfg, device: str = "cuda", jobs=SD_JOBS) -> dict:
    """Build the SD-1.5 engine, serve, submit the jobs and poll them to done;
    returns the engine, the counts, the finished jobs and the GET answers."""
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    reset_counts()
    t0 = time.perf_counter()
    engine = build_engine(cfg, device)
    log(f"sd15 engine ready in {time.perf_counter() - t0:.3f} s on {engine.device}: "
        f"build {engine.build_seconds}, first dispatch {engine.clock.entries}")
    done, gets = [], {}
    with BackgroundServer(cfg, engine) as srv:
        log(f"serving on 127.0.0.1:{srv.port}")
        ids = []
        for body in jobs:
            status, out = http(srv.port, "/v1/models/sd15:submit", body)
            check(status == 202, f":submit: status {status}: {out}")
            ids.append(out["job"]["id"])
        deadline = time.monotonic() + 600
        for job_id in ids:
            while True:
                status, out = http(srv.port, f"/v1/jobs/{job_id}")
                check(status == 200, f"/v1/jobs/{job_id}: status {status}: {out}")
                if out["job"]["status"] in ("done", "error"):
                    break
                check(time.monotonic() < deadline, f"job {job_id} still {out['job']['status']}")
                time.sleep(0.05)
            done.append(out["job"])
        counts = read_counts()  # just after the path
        for path, body in (("/v1/models/sd15:predict", {"prompt": "x"}), ("/healthz", None),
                           ("/v1/models", None), ("/metrics", None)):
            gets[path] = http(srv.port, path, body)
    return {"engine": engine, "counts": counts, "jobs": done, "gets": gets}


def check_sd(run: dict, size=(SD["height"], SD["width"])) -> list[np.ndarray]:
    images = []
    for body, job in zip(SD_JOBS, run["jobs"]):
        check(job["status"] == "done", f"job {job['id']}: {job}")
        result = job["result"]
        check(result["format"] == "png" and (result["height"], result["width"]) == size,
              f"job result {dict((k, v) for k, v in result.items() if k != 'image_b64')}")
        img = read_png(base64.b64decode(result["image_b64"]))
        check(img.shape == (*size, 3), f"PNG decodes to {img.shape}")
        check(img.std() > 0, "the image is constant")
        images.append(img)
        log(f":submit {json.dumps(body)}: done in {job['seconds']} s, PNG "
            f"{img.shape[1]}x{img.shape[0]}x3, pixel mean {img.mean():.2f} std {img.std():.2f}")
    status, out = run["gets"]["/v1/models/sd15:predict"]
    check(status == 405 and ":submit" in out["error"], f":predict on sd15: {status} {out}")
    status, out = run["gets"]["/v1/models"]
    check(status == 200 and out["models"]["sd15"]["async_only"] is True
          and out["models"]["sd15"]["endpoint"] == "/v1/models/sd15:submit", f"/v1/models: {out}")
    status, out = run["gets"]["/healthz"]
    check(status == 200 and out["device_ok"] is True and out["jobs_backlog"] == 0,
          f"/healthz: {out}")
    status, out = run["gets"]["/metrics"]
    check(status == 200 and out["jobs"]["backlog"] == 0
          and out["runner"]["sd15"]["batches"] == len(SD_JOBS), f"/metrics: {out}")
    log(f"/metrics: sd15 {out['runner']['sd15']}, jobs {out['jobs']}")
    return images


# -- phase 7: SD-1.5 parity against the plain version ----------------------------

# UNet eps, kernel vs plain route, relative max error (max|Δ| / max|eps|):
# each of the ten flash outputs differs from the plain version's by about one
# bf16 rounding (2^-8 relative), and the bf16 layers after them carry that on.
SD_EPS_RTOL = 5e-2
# The job seconds of phase 16's check 5 (run on phase 6's engine).
SD_EDGES: dict = {}
# The finished image, mean |Δ| over the uint8 values: twenty steps feed each
# step's small eps difference back through the sampler.
SD_IMAGE_MEAN_LSB = 4.0


def phase_sd_parity(engine, body: dict, served: np.ndarray) -> dict:
    """One UNet call with every long self-attention through the kernel and
    through the plain version, on one collated input; the PNG the job lane
    served for ``body`` against the same request through the same chunked
    route (prepare, 4-step chunks, finalize, PNG) with the plain version;
    and ms per denoise step from one 4-step chunk."""
    from pytorch_zappa_serverless_tpu_torch.engine.compiled import default_collate
    from pytorch_zappa_serverless_tpu_torch.models import sd15 as S
    from pytorch_zappa_serverless_tpu_torch.models import sd_unet as U
    from pytorch_zappa_serverless_tpu_torch.ops import flash_attention as FA

    cm = engine.model("sd15")
    ch = cm.servable.meta["chunked"]
    samples = [cm.servable.preprocess(body)]
    batch = default_collate(samples, (1,), cm.servable.input_spec((1,)))

    def plain(fn):
        U.flash = FA.flash_attention_reference
        try:
            return fn()
        finally:
            U.flash = FA.flash_attention

    def unet_eps():
        with torch.inference_mode():
            tree = cm.servable.module.tree()
            inputs = cm._place(batch)
            sd_cfg, dtype = cm.servable.meta["config"], cm.servable.meta["dtype"]
            context, _ = S.encode_condition(tree, inputs, sd_cfg, dtype)
            lat2 = torch.cat([inputs["latents"]] * 2)
            t2 = torch.full((2,), float(ch["chunk_rows"][0]["t"][0]), device=lat2.device)
            return U.unet_apply(tree["unet"], lat2, t2, context, sd_cfg.unet,
                                dtype).cpu().numpy()

    def step_ms():
        _, state = cm.chunk_prepare(samples)
        t0 = time.perf_counter()
        cm.chunk_step(state, ch["chunk_rows"][0])  # ends in a stream synchronize
        return (time.perf_counter() - t0) * 1e3 / ch["steps_per_chunk"]

    def job_png():
        """The job lane's route (runner.run_chunked's slices, the server's
        finalize) in one dispatch, each chunk eager (the captured chunk graph
        holds the kernel): the decoded PNG."""
        _, state = cm.chunk_prepare(samples)
        for rows in ch["chunk_rows"]:
            with torch.inference_mode():
                state = ch["chunk"](cm.servable.module.tree(), state, rows)
        result = cm.servable.meta["finalize"](cm.chunk_finalize(state, samples)[0])
        return read_png(base64.b64decode(result["image_b64"]))

    run = engine.runner.run_fn_sync
    eps_k, eps_p = run(unet_eps), run(lambda: plain(unet_eps))
    check(eps_k.shape == (2, *batch["latents"].shape[1:]), f"eps {eps_k.shape}")
    check(bool(np.isfinite(eps_k).all() and np.isfinite(eps_p).all()), "eps not finite")
    eps_err = float(np.abs(eps_k - eps_p).max() / np.abs(eps_p).max())
    check(eps_err <= SD_EPS_RTOL, f"UNet eps, kernel vs plain: rel max err {eps_err}")
    img_p = run(lambda: plain(job_png))
    check(img_p.shape == served.shape, f"plain route image {img_p.shape} vs {served.shape}")
    diff = np.abs(served.astype(np.int32) - img_p.astype(np.int32))
    img_err = float(diff.mean())
    check(img_err <= SD_IMAGE_MEAN_LSB, f"served image vs plain route: mean |d| {img_err} LSB")
    ms = [run(step_ms) for _ in range(3)]
    log(f"sd parity: UNet eps rel max err {eps_err:.4g} (<= {SD_EPS_RTOL}); the served PNG "
        f"vs the plain route's: mean |d| {img_err:.4g} LSB (<= {SD_IMAGE_MEAN_LSB}), "
        f"max {int(diff.max())}")
    log(f"sd denoise: {statistics.median(ms):.3f} ms per step (CFG batch 2, 512x512; one "
        f"replayed 4-step chunk, host clock to a stream synchronize; runs "
        f"{[round(m, 3) for m in ms]})")
    return {"eps_rel_err": eps_err, "image_mean_lsb": img_err,
            "ms_per_step": statistics.median(ms)}


def phase_sd_replay(engine, body: dict) -> None:
    """A job's chunks, each replayed through the chunk graph against the
    same chunk run eagerly on the same state and schedule rows: the latents
    after each chunk byte for byte, and each replay's launches exactly ten
    flash launches a UNet call, one UNet call a step."""
    cm = engine.model("sd15")
    ch = cm.servable.meta["chunked"]
    steps = ch["steps_per_chunk"]

    def chunks():
        _, state = cm.chunk_prepare([cm.servable.preprocess(body)])
        for i, rows in enumerate(ch["chunk_rows"]):
            with torch.inference_mode():
                want = ch["chunk"](cm.servable.module.tree(), state, rows)["latents"].cpu()
            reset_counts()
            state = cm.chunk_step(state, rows)
            exact_counts(read_counts(), {"flash_attention": 10 * steps, "unet_calls": steps},
                         f"sd chunk {i} replay")
            check(same_bits(state["latents"].cpu().numpy(), want.numpy()),
                  f"sd chunk {i}: replayed latents differ from eager: max |d| "
                  f"{(state['latents'].cpu() - want).abs().max().item()}")
        return len(ch["chunk_rows"])

    n = engine.runner.run_fn_sync(chunks)
    log(f"sd replay vs eager: the latents after each of {n} chunks bitwise equal; each "
        f"replay's launches exactly {10 * steps} flash, {steps} UNet calls")


def phase_sd_interleave(engine) -> None:
    """The two jobs through ``runner.run_chunked`` at once, so that their
    chunks take turns on the one bucket's chunk graph, against each job
    alone: the same pixels (hence the same PNG)."""
    import asyncio

    cm = engine.model("sd15")
    runner = engine.runner
    jobs = [[cm.servable.preprocess(body)] for body in SD_JOBS]
    alone = [asyncio.run(runner.run_chunked(cm, samples))[0]["pixels"] for samples in jobs]
    order = []
    chunk_step = cm.chunk_step

    def recording(state, rows):  # which job's state each chunk dispatch carried
        order.append(id(state["context"]))
        return chunk_step(state, rows)

    async def both():
        return await asyncio.gather(*(runner.run_chunked(cm, samples) for samples in jobs))

    cm.chunk_step = recording
    try:
        together = asyncio.run(both())
    finally:
        del cm.chunk_step
    turns = sum(a != b for a, b in zip(order, order[1:]))
    check(len(set(order)) == 2 and turns >= 2,
          f"the two jobs' chunks did not interleave: {turns} turns in {len(order)} chunks")
    for i, (a, t) in enumerate(zip(alone, together)):
        check(same_bits(t[0]["pixels"], a), f"sd job {i}: interleaved pixels differ from alone: "
                                            f"{int((t[0]['pixels'] != a).sum())} values")
    log(f"sd interleaved jobs: {len(order)} chunk dispatches, {turns} turns between the two "
        f"jobs; each job's pixels bitwise equal to the job run alone")


def phase_sd_edges(engine, bodies=SD_JOBS, reps: int = 3) -> dict:
    """SD-1.5's prepare (the CLIP encode) and finalize (the VAE decode)
    graphs against the same calls eagerly, on the dispatch thread: each
    job's state and pixels byte for byte, each replay's launches exactly
    none of the port's kernels (neither runs one), a job's state its own
    when another job's prepare replays after it; then one job through
    ``runner.run_chunked`` with both edges replayed against both eager
    (seconds, the median of ``reps``).  Phase 16's check 5, on the full-width
    engine of phase 6."""
    import asyncio

    cm = engine.model("sd15")
    ch = cm.servable.meta["chunked"]
    jobs = [[cm.servable.preprocess(body)] for body in bodies]
    check(not cm.graphed or (any(g.startswith("prepare") for g in cm.graphs)
                             and any(g.startswith("finalize") for g in cm.graphs)),
          f"sd15 warm-up captured no prepare or finalize graph: {cm.graphs}")

    def edges():
        states = []
        for samples in jobs:
            _, want = cm.chunk_prepare_eager(samples)
            reset_counts()
            _, got = cm.chunk_prepare(samples)
            exact_counts(read_counts(), {}, "sd prepare replay")
            for k in want:
                check(same_bits(got[k].float().cpu().numpy(), want[k].float().cpu().numpy()),
                      f"sd prepare replay: {k} differs from eager")
            states.append((got, {k: v.clone() for k, v in want.items()}))
        got, want = states[0]
        check(all(torch.equal(got[k], want[k]) for k in want),
              "sd prepare: the first job's state changed when the second job's prepare replayed")
        for (state, _), samples in zip(states, jobs):
            for rows in ch["chunk_rows"]:
                state = cm.chunk_step(state, rows)
            want = cm.chunk_finalize_eager(state, samples)
            reset_counts()
            got = cm.chunk_finalize(state, samples)
            exact_counts(read_counts(), {}, "sd finalize replay")
            check(same_bits(got[0]["pixels"], want[0]["pixels"]),
                  f"sd finalize replay: pixels differ from eager in "
                  f"{int((got[0]['pixels'] != want[0]['pixels']).sum())} values")

    engine.runner.run_fn_sync(edges)

    def job_s(eager: bool) -> float:
        if eager:
            cm.chunk_prepare, cm.chunk_finalize = cm.chunk_prepare_eager, cm.chunk_finalize_eager
        try:
            t0 = time.perf_counter()
            asyncio.run(engine.runner.run_chunked(cm, jobs[0]))
            return time.perf_counter() - t0
        finally:
            if eager:
                del cm.chunk_prepare, cm.chunk_finalize

    times = {kind: statistics.median(job_s(kind == "eager") for _ in range(reps))
             for kind in ("captured", "eager", "captured_again")}
    _, lh, lw, _ = cm.servable.input_spec((1,))["latents"][0]
    log(f"sd prepare and finalize graphs (phase 16 check 5): {len(jobs)} jobs' states and "
        f"pixels bitwise equal to eager, no kernel of the port launched; a {8 * lh}x{8 * lw} "
        f"{cm.servable.meta['num_steps']}-step job through run_chunked: edges captured "
        f"{times['captured']:.4f} s "
        f"({times['captured_again']:.4f} s again), eager {times['eager']:.4f} s "
        f"(median of {reps})")
    return times


def phase_sd_profile(engine, body: dict) -> None:
    """``torch.profiler`` over one 4-step chunk on the dispatch thread, eager
    against replayed: device time by kernel name, the device's idle share of
    the window and the host's launch calls."""
    from pytorch_zappa_serverless_tpu_torch.tools import bench_fused_decode as BF

    cm = engine.model("sd15")
    ch = cm.servable.meta["chunked"]
    rows = ch["chunk_rows"][1]

    def window(replay: bool):
        _, state = cm.chunk_prepare([cm.servable.preprocess(body)])

        def eager():
            with torch.inference_mode():
                ch["chunk"](cm.servable.module.tree(), state, rows)

        return BF.profile((lambda: cm.chunk_step(state, rows)) if replay else eager, 1)

    run = engine.runner.run_fn_sync
    log_profiles("sd15 chunk", "step", run(window, False), run(window, True),
                 per=ch["steps_per_chunk"], top=15)


# -- optional: where one forward's device time goes --------------------------

def phase_profile(engine, instances: list[dict], seq: int = BERT["seq"],
                  forwards: int = 5) -> None:
    """``torch.profiler`` over ``forwards`` forwards of one batch on the
    dispatch thread, eager (``forward_eager``) against replayed (the
    served ``forward``): device time by kernel name, the device's idle
    share of the window (host clock, ending in a synchronize) and the host's
    launch calls."""
    from pytorch_zappa_serverless_tpu_torch.tools import bench_fused_decode as BF

    cm = engine.model("bert_base")
    bucket, batch = collate(cm, instances, seq)
    run = engine.runner.run_fn_sync
    eager = run(BF.profile, lambda: cm.forward_eager(batch), forwards)
    replay = run(BF.profile, lambda: cm.forward(batch), forwards)
    log_profiles(f"bert {bucket}", "forward", eager, replay)


def run_bert(profile: bool) -> int:
    """The BERT path, its checks, replay against eager, and parity; returns
    int8_matmul's launches."""
    cfg = serve_config()
    fresh_memory()
    run = phase_main_path(cfg)
    engine = run["engine"]
    try:
        log_memory("bert", engine)
        check_answers(run)
        DEPLOY_REF["bert"] = [(p, b, out["predictions"]) for p, b, out in run["answers"]]
        per_fwd = 6 * BERT["layers"]
        launches = run["launches"]["int8_matmul"]
        check(launches > 0, "int8_matmul was not launched on the main path")
        check(launches == per_fwd * run["forwards"],
              f"int8_matmul launches {launches} != {per_fwd} x {run['forwards']} forwards")
        log(f"main path: {run['forwards']} forwards ({len(engine.clock.entries)} captures' "
            f"eager warm-up runs, {run['batches']} served batches, each a replay), "
            f"int8_matmul launched {launches} times")
        instances = next(b for p, b, _ in run["answers"] if "instances" in b)["instances"]
        cm = engine.model("bert_base")
        phase_replay(engine, "bert_base", [
            ("(1,128)", collate(cm, instances[:1], BERT["seq"])[1]),
            ("(8,128) a", collate(cm, instances, BERT["seq"])[1]),
            ("(8,128) b", collate(cm, instances[::-1][:5], BERT["seq"])[1])],
            {"int8_matmul": per_fwd})
        ring = run["gets"]["/metrics"]["models"]["bert_base"]
        log(f"request latency p50 {ring['total_ms']['p50']} ms, p99 "
            f"{ring['total_ms']['p99']} ms over {ring['requests']} samples "
            f"(device p50 {ring['device_ms']['p50']} ms)")
        parity = phase_parity(engine, instances)
        check(parity["dense_modules"] == per_fwd, f"{parity['dense_modules']} Int8Dense")
        if profile:
            phase_profile(engine, instances[:1])
            phase_profile(engine, instances)
    finally:
        engine.shutdown()
    return launches


def run_sd(profile: bool, checkpoint: str | None = None) -> int:
    """The SD-1.5 path, its checks and parity, with the weights of
    ``checkpoint`` (phase 22a's staged tree, the seeded tree's bytes) or the
    seed; returns flash_attention's launches."""
    t0 = time.perf_counter()
    fresh_memory()
    run = phase_sd_path(sd_config(checkpoint=checkpoint))
    engine = run["engine"]
    try:
        log_memory("sd15", engine)
        images = check_sd(run)
        DEPLOY_REF.update(sd_body=SD_JOBS[0], sd_png=run["jobs"][0]["result"]["image_b64"])
        counts = run["counts"]
        launches, calls = counts["flash_attention"], counts["unet_calls"]
        check(calls > 0 and launches > 0, f"the SD path ran no UNet or no kernel: {counts}")
        check(launches == 10 * calls,
              f"flash_attention launches {launches} != 10 x {calls} UNet calls")
        check(counts["int8_matmul"] == 0, f"int8_matmul launched on the SD path: {counts}")
        log(f"sd path: {calls} UNet calls (8 at warm-up: the chunk graph's eager run and one "
            f"replay; 20 per job, replayed), flash_attention launched {launches} times; path "
            f"in {time.perf_counter() - t0:.3f} s")
        phase_sd_replay(engine, SD_JOBS[1])
        phase_sd_interleave(engine)
        SD_EDGES.update(phase_sd_edges(engine))
        parity = phase_sd_parity(engine, SD_JOBS[0], images[0])
        if profile:
            phase_sd_profile(engine, SD_JOBS[0])
    finally:
        engine.shutdown()
    seconds = [job["seconds"] for job in run["jobs"]]
    log(f"sd job seconds (started → finished, 512x512, 20 steps): {seconds}; "
        f"{parity['ms_per_step']:.3f} ms per denoise step")
    return launches


# -- phase 8: the GPT-2 path -----------------------------------------------------

GPT2 = {"seq": 64, "batch_buckets": (1, 8), "max_new_tokens": 32}
GPT2_WORDS = ("the quick brown fox jumps over the lazy dog while a server answers "
              "every request it is sent").split()
GPT2_SAMPLED = {"text": "a sampled continuation of this prompt", "temperature": 0.8,
                "top_k": 40, "top_p": 0.95, "seed": 7}
# Served int8 logits, kernel vs plain route, relative max error (max|Δ| /
# max|want|): each projection's bf16 output may round one ulp apart (2^-8
# relative), and twelve layers carry that on.
GPT2_LOGIT_RTOL = 2e-2


def gpt2_config(arch: dict | None = None, seq: int = GPT2["seq"],
                batch_buckets=GPT2["batch_buckets"],
                max_new_tokens: int = GPT2["max_new_tokens"], **extra):
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig

    extra = {"params_dtype": "int8", "max_new_tokens": max_new_tokens,
             **({"arch": arch} if arch else {}), **extra}
    return ServeConfig(models=[ModelConfig(
        name="gpt2", dtype="bfloat16", seq_buckets=(seq,),
        batch_buckets=tuple(batch_buckets), extra=extra)])


def gpt2_instances(n: int = 8) -> list[dict]:
    """``n`` prompts of ragged lengths (3 to 3 + n - 1 words)."""
    return [{"text": " ".join(GPT2_WORDS[: 3 + i])} for i in range(n)]


def phase_gpt2_path(cfg, device: str = "cuda") -> dict:
    """Build the GPT-2 engine, serve, and answer ``:predict`` requests (text,
    input_ids, 8 ragged instances, one sampled request twice), then the GETs;
    returns the engine, the counts, the generate calls run and the answers."""
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    reset_counts()
    t0 = time.perf_counter()
    engine = build_engine(cfg, device)
    log(f"gpt2 engine ready in {time.perf_counter() - t0:.3f} s on {engine.device}: "
        f"build {engine.build_seconds}, first dispatch per bucket {engine.clock.entries}")
    path = "/v1/models/gpt2:predict"
    requests = [{"text": "the port serves text generation on the card"},
                {"input_ids": list(range(100, 140))},
                {"instances": gpt2_instances()}, GPT2_SAMPLED, GPT2_SAMPLED]
    answers, gets = [], {}
    with BackgroundServer(cfg, engine) as srv:
        log(f"serving on 127.0.0.1:{srv.port}")
        for body in requests:
            status, out = http(srv.port, path, body)
            check(status == 200, f"{path}: status {status}: {out}")
            answers.append((body, out))
        counts = read_counts()  # just after the path
        for get in ("/healthz", "/v1/models", "/metrics"):
            status, out = http(srv.port, get)
            check(status == 200, f"{get}: status {status}: {out}")
            gets[get] = out
    st = engine.runner.stats["gpt2"]
    calls = len(engine.clock.entries) + st.batches
    return {"engine": engine, "counts": counts, "generate_calls": calls,
            "batches": st.batches, "answers": answers, "gets": gets}


def check_gpt2(run: dict, vocab: int = 50257, max_new: int = GPT2["max_new_tokens"]) -> None:
    for body, out in run["answers"]:
        check(out.get("model") == "gpt2" and {"timing", "predictions"} <= set(out),
              f"gpt2 response keys {sorted(out)}")
        preds = out["predictions"] if "instances" in body else [out["predictions"]]
        check(len(preds) == len(body.get("instances", [body])), f"{len(preds)} predictions")
        for pred in preds:
            toks = pred["tokens"]
            check(isinstance(toks, list) and len(toks) <= max_new
                  and all(isinstance(t, int) and 0 <= t < vocab for t in toks),
                  f"gpt2 tokens {toks}")
        log(f"gpt2 :predict {json.dumps(body)[:60]}...: 200, {[len(p['tokens']) for p in preds]} "
            f"tokens, timing {out['timing']}")
    (_, first), (_, second) = run["answers"][-2:]
    check(first["predictions"] == second["predictions"],
          f"the sampled request answered twice differently: {first['predictions']} vs "
          f"{second['predictions']}")
    log(f"gpt2 sampled request (T=0.8, top_k=40, top_p=0.95, seed=7) twice: the same "
        f"{len(first['predictions']['tokens'])} tokens")
    check(run["gets"]["/healthz"]["device_ok"] is True, f"/healthz: {run['gets']['/healthz']}")
    check("gpt2" in run["gets"]["/v1/models"]["models"], "/v1/models misses gpt2")
    ring = run["gets"]["/metrics"]["models"]["gpt2"]
    log(f"gpt2 request latency p50 {ring['total_ms']['p50']} ms, p99 {ring['total_ms']['p99']} "
        f"ms over {ring['requests']} samples (device p50 {ring['device_ms']['p50']} ms)")


def phase_gpt2_parity(engine, instances: list[dict], steps: int = 4) -> dict:
    """Prefill logits and ``steps`` teacher-forced decode-step logits of the
    served int8 model, its products through the kernel, against the same
    model with ``int8_matmul`` routed to its plain version, on the card, on
    one collated batch of ragged prompts (both fed the kernel route's
    greedy tokens)."""
    from pytorch_zappa_serverless_tpu_torch.models import gpt2 as G
    from pytorch_zappa_serverless_tpu_torch.ops import int8_matmul as I

    cm = engine.model("gpt2")
    samples = [cm.servable.preprocess(p) for p in instances]
    bucket = cm.bucket_for(len(samples), max(cm.servable.meta["seq_len_of"](s) for s in samples))
    batch = cm.servable.meta["collate"](samples, bucket, cm.servable.input_spec(bucket))
    cfg = cm.servable.meta["config"]
    fed: list = []  # the tokens both routes are fed: the kernel route's greedy picks

    def logits_chain(matmul):
        G.int8_mm = matmul
        try:
            with torch.inference_mode():
                tree, x = cm.servable.module.tree(), cm._place(batch)
                total = bucket[1] + steps
                out = []
                logits, ck, cv = G.prefill(tree, x["input_ids"], x["length"], total, cfg)
                out.append(logits)
                pos = x["length"].clone()
                for t in range(steps):
                    if t == len(fed):
                        fed.append(logits.argmax(-1).to(torch.int32))
                    tok = fed[t]
                    logits = G.decode_step(tree, ck, cv, tok, pos, cfg)
                    out.append(logits)
                    pos = pos + 1
                return [o[: len(samples)].cpu() for o in out]
        finally:
            G.int8_mm = I.int8_matmul

    run = engine.runner.run_fn_sync
    got = run(logits_chain, I.int8_matmul)
    want = run(logits_chain, I.int8_matmul_reference)
    errs = []
    for t, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape == (len(samples), cfg.vocab_size), f"logits {g.shape}")
        check(bool(torch.isfinite(g).all()), f"step {t}: logits not finite")
        errs.append(((g - w).abs().max() / w.abs().max()).item())
    worst = max(errs)
    check(worst <= GPT2_LOGIT_RTOL, f"gpt2 kernel vs plain logits: rel max err {errs}")
    log(f"gpt2 parity: prefill + {steps} teacher-forced steps on bucket {bucket}, kernel vs "
        f"plain int8_matmul: rel max err per step {[round(e, 6) for e in errs]} "
        f"(<= {GPT2_LOGIT_RTOL})")
    return {"logit_rel_err": worst}


def gpt2_batch(cm, instances: list[dict]) -> dict:
    """The collated host batch of ``instances``, in their bucket."""
    samples = [cm.servable.preprocess(p) for p in instances]
    bucket = cm.bucket_for(len(samples), max(cm.servable.meta["seq_len_of"](s) for s in samples))
    return cm.servable.meta["collate"](samples, bucket, cm.servable.input_spec(bucket))


def phase_gpt2_profile(engine, instances: list[dict]) -> None:
    """``torch.profiler`` over one generate call (prefill + 32 decode steps)
    of a collated batch on the dispatch thread, eager against replayed:
    device time by kernel name, the device's idle share of the window and
    the host's launch calls."""
    from pytorch_zappa_serverless_tpu_torch.tools import bench_fused_decode as BF

    cm = engine.model("gpt2")
    batch = gpt2_batch(cm, instances)
    run = engine.runner.run_fn_sync
    eager = run(BF.profile, lambda: cm.forward_eager(batch), 1)
    replay = run(BF.profile, lambda: cm.forward(batch), 1)
    log_profiles(f"gpt2 {tuple(batch['input_ids'].shape)}", "step", eager, replay,
                 per=1 + GPT2["max_new_tokens"])


def run_gpt2(profile: bool) -> int:
    """The GPT-2 path, its checks, replay against eager, and parity; returns
    int8_matmul's launches."""
    fresh_memory()
    run = phase_gpt2_path(gpt2_config())
    engine = run["engine"]
    try:
        log_memory("gpt2", engine)
        check_gpt2(run)
        counts = run["counts"]
        # Per forward position step: 4 projections x 12 layers + the lm head;
        # one generate call is a prefill and max_new_tokens decode steps.
        per_call = (4 * 12 + 1) * (1 + GPT2["max_new_tokens"])
        launches = counts["int8_matmul"]
        check(launches > 0, "int8_matmul was not launched on the GPT-2 path")
        check(launches == per_call * run["generate_calls"],
              f"int8_matmul launches {launches} != {per_call} x {run['generate_calls']} "
              f"generate calls")
        check(all(counts[fn] == 0 for fn in FUSED_ENTRY_POINTS),
              f"the fused decode kernels ran on the serving path: {counts}")
        log(f"gpt2 path: {run['generate_calls']} generate calls "
            f"({len(engine.clock.entries)} captures' eager warm-up runs, {run['batches']} "
            f"served batches, each a replay), int8_matmul launched {launches} times "
            f"({per_call} per call)")
        cm = engine.model("gpt2")
        sampled = [{**p, **{k: v for k, v in GPT2_SAMPLED.items() if k != "text"}, "seed": i}
                   for i, p in enumerate(gpt2_instances())]
        phase_replay(engine, "gpt2", [
            ("(1,64) greedy", gpt2_batch(cm, gpt2_instances(1))),
            ("(1,64) sampled", gpt2_batch(cm, [GPT2_SAMPLED])),
            ("(8,64) greedy a", gpt2_batch(cm, gpt2_instances())),
            ("(8,64) sampled", gpt2_batch(cm, sampled)),
            ("(8,64) greedy b", gpt2_batch(cm, gpt2_instances()[::-1][:6]))],
            {"int8_matmul": per_call})
        phase_gpt2_parity(engine, gpt2_instances())
        if profile:
            phase_gpt2_profile(engine, gpt2_instances())
    finally:
        engine.shutdown()
    return launches


# -- phase 9: the fused decode loop ------------------------------------------------

FUSED_STEPS = 32
# Fused kernel vs plain version, per element |y - want| <= atol + rtol·|want|:
# rtol = 2^-7 is one bf16 rounding of the output (the two sides round nearly
# equal f32 sums and may land one ulp apart at the bottom of a binade); atol
# covers outputs near 0, where an intermediate (h, qkv, ctx, h1) rounded to
# bf16 the other way moves the f32 sum by ~1e-4 at these widths.  The planted
# fault reads 7x to 34x this limit at GPT-2 small.
FUSED_TOL = (1e-3, 2 ** -7)


def device_ms(fn, reps: int = 15) -> float:
    """Median device time of ``fn``'s launches by CUDA events: a spin kernel
    holds the stream while the host queues them, so the host's time per
    launch (Python checks, ctypes) leaves no gaps between them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(3 * host_s * 2e9) + 2_000_000  # ~3x the host's time at ~2 GHz
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def attn_bytes(S: int, D: int, T: int, wbytes: int) -> int:
    """Bytes an attention launch must move: its weights, both caches read
    once, x read and x_out written, the K/V rows written, norms, biases,
    scales (int8), the mask and pos."""
    scales = 4 * 4 * D if wbytes == 1 else 0
    return (wbytes * 4 * D * D + 2 * T * S * D * 2 + 2 * S * D * 2 + 2 * S * D * 2
            + 4 * 6 * D + scales + 4 * T * S + 4 * S)


def mlp_bytes(S: int, D: int, F: int, wbytes: int) -> int:
    scales = 4 * (F + D) if wbytes == 1 else 0
    return wbytes * 2 * D * F + 2 * S * D * 2 + 4 * (3 * D + F) + scales


def fused_bound(kind: str, S: int, D: int, T: int, F: int, wbytes: int) -> dict:
    """Least time of one launch: the bytes at the memory rate against the
    products (and, for attention, the scores and P·V) at the bf16 peak."""
    if kind == "attn":
        nbytes, ops = attn_bytes(S, D, T, wbytes), 2 * S * 4 * D * D + 4 * S * T * D
    else:
        nbytes, ops = mlp_bytes(S, D, F, wbytes), 2 * S * 2 * D * F
    b_ms, o_ms = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * ops / PEAK_BF16_FLOPS
    return {"bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "bytes": nbytes}


def layer_calls(p: dict, cks, cvs, pos, mask, cfg, int8: bool, plain: bool):
    """(attention, mlp) callables of each layer: the kernel wrappers, or their
    plain versions on the same operands."""
    from pytorch_zappa_serverless_tpu_torch.ops import fused_decode as FD

    out = []
    for i in range(cfg.layers):
        lp = p[f"layer{i}"]
        ln1, ln2, qkv, o, fc1, fc2 = (lp[n] for n in ("ln1", "ln2", "qkv", "out", "fc1", "fc2"))
        kw = {"eps": cfg.ln_eps}
        if int8:
            wq, wo, w1, w2 = qkv["kernel_q"], o["kernel_q"], fc1["kernel_q"], fc2["kernel_q"]
            sc = {"sqkv": qkv["scale"], "sout": o["scale"]}
            sm = {"s1": fc1["scale"], "s2": fc2["scale"]}
        else:
            wq, wo, w1, w2 = qkv["kernel"], o["kernel"], fc1["kernel"], fc2["kernel"]
            sc, sm = {}, {}

        def attn(x, ck=cks[i], cv=cvs[i], ln1=ln1, qkv=qkv, o=o, wq=wq, wo=wo, sc=sc,
                 mask=mask):
            if plain:
                return FD.fused_attn_step_reference(
                    x, ln1["scale"], ln1["bias"], wq, qkv["bias"], wo, o["bias"], ck, cv, pos,
                    mask, heads=cfg.heads, **kw, **sc)
            if int8:
                return FD.fused_attn_step_int8(
                    x, ln1["scale"], ln1["bias"], wq, qkv["bias"], sc["sqkv"], wo, o["bias"],
                    sc["sout"], ck, cv, pos, mask, heads=cfg.heads, **kw)
            return FD.fused_attn_step(x, ln1["scale"], ln1["bias"], wq, qkv["bias"], wo,
                                      o["bias"], ck, cv, pos, mask, heads=cfg.heads, **kw)

        def mlp(x, ln2=ln2, fc1=fc1, fc2=fc2, w1=w1, w2=w2, sm=sm):
            if plain:
                return FD.fused_mlp_step_reference(x, ln2["scale"], ln2["bias"], w1,
                                                   fc1["bias"], w2, fc2["bias"], **kw, **sm)
            if int8:
                return FD.fused_mlp_step_int8(x, ln2["scale"], ln2["bias"], w1, fc1["bias"],
                                              sm["s1"], w2, fc2["bias"], sm["s2"], **kw)
            return FD.fused_mlp_step(x, ln2["scale"], ln2["bias"], w1, fc1["bias"], w2,
                                     fc2["bias"], **kw)

        out.append((attn, mlp))
    return out


def phase_fused_kernels(lane, cfg, int8: bool) -> dict:
    """Each layer's two kernels of one step against their plain versions on
    the same operands (caches cloned, so the lane's stay as they are), per
    element within ``FUSED_TOL``; the planted fault (the plain version with
    key pos[s] itself masked) must read > 5x the limit; per-launch times of
    the kernels and the plain versions over all twelve layers."""
    from pytorch_zappa_serverless_tpu_torch.models import gpt2 as G
    from pytorch_zappa_serverless_tpu_torch.tools import bench_fused_decode as BF

    atol, rtol = FUSED_TOL
    tag = "int8" if int8 else "bf16"
    with torch.inference_mode():
        pos = lane.pos.to(torch.int32)
        mask = BF.mask_bias(pos, BF.T)
        bad_mask = mask.clone()
        bad_mask[pos.long(), torch.arange(BF.S, device=pos.device)] = -1e9
        x = G._embed(lane.params, lane.tok, pos, cfg, BF.DTYPE).contiguous()
        ck = [c.clone() for c in lane.ck]
        cv = [c.clone() for c in lane.cv]
        kern = layer_calls(lane.params, ck, cv, pos, mask, cfg, int8, plain=False)
        shares, faults, max_err = [], [], 0.0
        for i, (attn, mlp) in enumerate(kern):
            ck_p, cv_p = ck[i].clone(), cv[i].clone()
            plain = layer_calls(lane.params, [ck_p] * cfg.layers, [cv_p] * cfg.layers, pos,
                                mask, cfg, int8, plain=True)[i]
            y, _, _ = attn(x)
            want, _, _ = plain[0](x)
            rows = (pos.long(), torch.arange(BF.S, device=pos.device))
            for got_c, want_c in ((ck[i], ck_p), (cv[i], cv_p)):
                row_share = tol_share(got_c[rows], want_c[rows], 1e-6, rtol)
                check(row_share <= 1, f"fused_attn_step {tag} layer {i}: the K/V rows "
                                      f"written at pos are {row_share:.3g} x the tolerance")
            fault = layer_calls(lane.params, [ck_p.clone()] * cfg.layers,
                                [cv_p.clone()] * cfg.layers, pos, bad_mask, cfg, int8,
                                plain=True)[i][0](x)[0]
            faults.append(tol_share(y, fault, atol, rtol))
            x2 = mlp(y)
            want2 = plain[1](y)
            for name, g, w in (("fused_attn_step", y, want), ("fused_mlp_step", x2, want2)):
                check(bool(torch.isfinite(g.float()).all()), f"{name} {tag} layer {i}: "
                                                              f"non-finite output")
                share = tol_share(g, w, atol, rtol)
                check(share <= 1, f"{name} {tag} layer {i}: {share:.3g} x the tolerance "
                                  f"(atol={atol}, rtol={rtol:.4g})")
                shares.append(share)
                max_err = max(max_err, (g.float() - w.float()).abs().max().item())
            x = x2
        sync(x.device)
        # Rejected at every layer, by more than 5x the limit.
        check(min(faults) > 5,
              f"fused_attn_step {tag}: the planted fault (key pos[s] masked) reads only "
              f"{min(faults):.3g} to {max(faults):.3g} x the tolerance")
        log(f"fused kernels {tag}, {cfg.layers} layers x (attention, mlp) of one step vs plain: "
            f"max |err| {max_err:.3g}, largest share {max(shares):.3f} of the tolerance "
            f"(atol={atol}, rtol={rtol:.4g}); planted fault (key pos[s] masked) reads "
            f"{min(faults):.3g} to {max(faults):.3g} x the tolerance: rejected")

        # Per launch over all twelve layers: ~85 MB (attention) and ~113 MB
        # (mlp) of bf16 weights and caches per pass stream from HBM, where one
        # layer's few MB would sit in the 50 MB L2 between repeats.
        x0 = G._embed(lane.params, lane.tok, pos, cfg, BF.DTYPE).contiguous()
        plain_calls = layer_calls(lane.params, ck, cv, pos, mask, cfg, int8, plain=True)

        def sweep(calls, which):
            def fn():
                for c in calls:
                    c[which](x0)
            return fn

        timing = {}
        for kind, which in (("attn", 0), ("mlp", 1)):
            row = {"ms": device_ms(sweep(kern, which)) / cfg.layers,
                   "plain_ms": device_ms(sweep(plain_calls, which), reps=5) / cfg.layers,
                   **fused_bound(kind, BF.S, cfg.d_model, BF.T, cfg.ffn_dim, 1 if int8 else 2)}
            timing[kind] = row
            log(f"time fused_{kind}_step {tag} [S={BF.S}, D={cfg.d_model}, T={BF.T}]: kernel "
                f"{row['ms']:.5f} ms per launch, plain {row['plain_ms']:.5f} ms, bound "
                f"{row['bound_ms']:.5f} ms ({row['bytes'] / 1e6:.2f} MB, {row['bound_by']}); "
                f"device time over the 12 layers' launches, queued behind a spin kernel")
    return {"max_abs_err": max_err, "timing": timing, "fault_min": min(faults)}


def teacher_forced(lane, ref_ck, ref_cv, cfg, int8: bool, steps: int) -> dict:
    """``steps`` steps of the fused lane, each held against the unfused
    serving step (``models.gpt2.decode_step``) on the same weights and its
    own serving caches; both are fed the unfused step's greedy token.  The
    fused lane's tokens must agree wherever the reference's top-2 margin
    exceeds twice the step's logit error."""
    from pytorch_zappa_serverless_tpu_torch.models import gpt2 as G
    from pytorch_zappa_serverless_tpu_torch.tools import bench_fused_decode as BF

    fn = BF.fused_step_int8 if int8 else BF.fused_step
    errs, agree, decided = [], 0, 0
    tok, pos = lane.tok, lane.pos
    with torch.inference_mode():
        for _ in range(steps):
            nxt, got = fn(lane.params, lane.ck, lane.cv, tok, pos, cfg)
            want = G.decode_step(lane.params, ref_ck, ref_cv, tok, pos, cfg, BF.DTYPE)
            check(bool(torch.isfinite(got).all()), "fused step logits not finite")
            err = (got - want).abs().max().item()
            top2 = want.topk(2, dim=-1).values
            margin = top2[:, 0] - top2[:, 1]
            sure = margin > 2 * err
            same = nxt == want.argmax(-1).to(torch.int32)
            check(bool(same[sure].all()), f"fused step tokens differ where the margin "
                                          f"exceeds 2 x {err:.3g}: {nxt} vs {want.argmax(-1)}")
            errs.append(err / want.abs().max().item())
            agree += int(same.sum())
            decided += int(sure.sum())
            tok, pos = want.argmax(-1).to(torch.int32), (pos + 1).clamp(max=BF.T - 1)
        lane.tok.copy_(tok)  # in place: a captured step reads these buffers
        lane.pos.copy_(pos)
    return {"rel_err": max(errs), "agree": agree, "decided": decided, "rows": steps * BF.S}


def phase_fused_replay(lanes: dict, cfg, steps: int = FUSED_STEPS) -> None:
    """Each lane's captured step replayed ``steps`` times (each feeding back
    its token and moving its position on) against ``steps`` eager steps from
    the same state: the emitted tokens and the caches after the last step
    byte for byte, and the replays' launches exactly 12 of each of the
    lane's two fused entry points a step (none on ``seg1``)."""
    from pytorch_zappa_serverless_tpu_torch.tools import bench_fused_decode as BF

    for name, lane in lanes.items():
        if lane.tok.is_cuda:
            BF.step_graph(lane, cfg, advance=True)  # captured before the counts
        start = lane.state()
        eager = [BF.eager_step(lane, cfg) for _ in range(steps)]
        eager_state = lane.state()
        lane.set_state(start)
        reset_counts()
        replayed = [BF.step(lane, cfg).clone() for _ in range(steps)]
        sync(lane.tok.device)
        kinds = {"fused": ("fused_attn_step", "fused_mlp_step"),
                 "fused_int8": ("fused_attn_step_int8", "fused_mlp_step_int8")}.get(name, ())
        want = {fn: cfg.layers * steps for fn in kinds}
        if name == "fused_int8":
            want["int8_matmul"] = steps  # the int8 lm head
        exact_counts(read_counts(), want, f"{name} lane, {steps} replayed steps")
        check(all(torch.equal(a, b) for a, b in zip(eager, replayed)),
              f"{name} lane: replayed tokens differ from eager ones")
        check(all(torch.equal(a, b) for a, b in zip(eager_state, lane.state())),
              f"{name} lane: the caches after {steps} replayed steps differ from eager ones")
        log(f"fused decode {name}: {steps} replayed steps vs {steps} eager steps from the same "
            f"state: tokens and caches bitwise equal; launches {want or 'no fused kernel'}")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_fused(profile: bool, cfg=None, device: str = "cuda") -> dict:
    """The fused decode loop at the bench's shapes (S = 8 rows, prompts of 32
    to 64 tokens through the port's prefill, cache T = 96) on GPT-2 small
    (``cfg`` narrows it for a rehearsal): the kernels against their plain
    versions, then 32 teacher-forced steps per fused lane held against the
    unfused step, then ms per step of the three lanes."""
    from pytorch_zappa_serverless_tpu_torch.models import gpt2 as G
    from pytorch_zappa_serverless_tpu_torch.tools import bench_fused_decode as BF

    cfg = cfg or G.SMALL
    t0 = time.perf_counter()
    lanes = BF.build_lanes(cfg, device)
    log(f"fused decode: three lanes built and prefilled in {time.perf_counter() - t0:.3f} s "
        f"(S={BF.S}, prompts {BF.prompts(cfg)[1].tolist()}, T={BF.T})")
    kern = {name: phase_fused_kernels(lanes[name], cfg, name == "fused_int8")
            for name in ("fused", "fused_int8")}
    # The unfused reference's serving caches: the same prefill, [L, S, T, D].
    refs = {}
    with torch.inference_mode():
        for name in ("fused", "fused_int8"):
            toks, lengths = (torch.from_numpy(a).to(device) for a in BF.prompts(cfg))
            _, ck, cv = G.prefill(lanes[name].params, toks, lengths, BF.T, cfg, BF.DTYPE)
            refs[name] = (ck, cv)
    sync(device)
    reset_counts()
    tf = {name: teacher_forced(lanes[name], *refs[name], cfg, name == "fused_int8",
                               FUSED_STEPS) for name in ("fused", "fused_int8")}
    sync(device)
    counts = read_counts()  # just after the path
    # Each lane takes FUSED_STEPS steps: the bf16 entry points run on "fused",
    # the int8 ones on "fused_int8", 12 launches of each kernel a step.
    check(all(counts[fn] == cfg.layers * FUSED_STEPS for fn in FUSED_ENTRY_POINTS),
          f"fused launches {counts} != {cfg.layers} x {FUSED_STEPS} steps of each lane")
    for name, r in tf.items():
        log(f"fused decode {name}: {FUSED_STEPS} teacher-forced steps vs the unfused step: "
            f"logit rel max err {r['rel_err']:.4g}; tokens agree on {r['agree']} of "
            f"{r['rows']} rows, on all {r['decided']} whose top-2 margin exceeds 2 x the error")
    log("fused decode: launches " + ", ".join(f"{fn} {counts[fn]}" for fn in FUSED_ENTRY_POINTS)
        + f" ({cfg.layers} of each kernel per step, {FUSED_STEPS} steps a lane)")
    phase_fused_replay(lanes, cfg)
    ms = {name: BF.time_lane(lane, cfg) for name, lane in lanes.items()}
    eager_ms = {name: BF.time_lane(lane, cfg, replay=False) for name, lane in lanes.items()}
    log(f"decode step, ms per step (S={BF.S}, T={BF.T}, CUDA events over 60 steps), replayed "
        f"graph / eager: " + ", ".join(f"{n} {ms[n]:.4f} / {eager_ms[n]:.4f}" for n in ms))
    lm = {"fused": 2 * cfg.vocab_size * cfg.d_model, "fused_int8": cfg.vocab_size * cfg.d_model}
    for name in ("fused", "fused_int8"):
        t = kern[name]["timing"]
        bound = cfg.layers * (t["attn"]["bound_ms"] + t["mlp"]["bound_ms"]) \
            + 1e3 * lm[name] / PEAK_BYTES_PER_S
        log(f"decode step {name}: {ms[name]:.4f} ms against a bound of {bound:.4f} ms "
            f"(24 launches + the lm head's weights)")
    if profile:
        for name, lane in lanes.items():
            log_profiles(f"{name} lane", "step",
                         BF.profile_lane(lane, cfg, replay=False),
                         BF.profile_lane(lane, cfg))
        # Where one launch of each fused kernel spends its time: %globaltimer
        # stamps at the phase boundaries of every block (a stamped build).
        from pytorch_zappa_serverless_tpu_torch.tools import fused_ablation as FAB

        check(FAB.main(["--variants", "", "--stamp-reps", "3"]) == 0, "fused phase stamps failed")
    return {"counts": counts, "kernels": kern, "ms": ms, "eager_ms": eager_ms,
            "teacher_forced": tf}


# -- phase 10: the vision path ----------------------------------------------------

# Full-width models at 224x224 (resize 256), seed weights; ResNet-50 at the
# JAX package's dev-profile buckets.
VISION = {"resnet50": (1, 4, 8, 32), "resnet18": (1, 8), "efficientnet_b0": (1, 8)}
VISION_SIZE = 224
VISION_SERVED = 60  # sequential single-image requests for the served p50
# bf16 served top-k against an fp32 eager run (TF32 off) of the same weights,
# on the fp32 top-k indices: |ln p_bf16 - ln p_fp32| <= 2·VISION_TAU·sigma,
# sigma the fp32 logits' standard deviation.  bf16 rounds every conv output,
# BN and activation (2^-8 relative); over 18 to 50 layers that moves each
# logit by a share of the logits' spread (CPU rehearsal at 224x224: 1.7% of
# sigma on ResNet-18, 2.2% on ResNet-50, 1.4% on EfficientNet-B0), and a
# log-probability moves by at most twice the largest logit's move.
VISION_TAU = 0.05
# Top-1: every row whose fp32 top-1 leads its top-2 by more than twice the
# tolerance in log-probability must agree (a swap would break the
# tolerance), and at least this many of the 8 rows in all.
VISION_TOP1_MIN = 6


def vision_config(image_size: int = VISION_SIZE, buckets: dict = VISION):
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig

    extra = {"image_size": image_size, "resize_to": image_size * 8 // 7}
    return ServeConfig(models=[ModelConfig(name=name, dtype="bfloat16", batch_buckets=tuple(b),
                                           extra=dict(extra))
                               for name, b in buckets.items()])


def vision_pngs(n: int = 8, seed: int = 0) -> list[bytes]:
    """``n`` PNGs (the port's own encoder) of other sizes and aspect ratios:
    blocks of colour, a gradient and a little noise, made from ``seed``."""
    from pytorch_zappa_serverless_tpu_torch.models.sd15 import png_bytes

    rng = np.random.default_rng(seed)
    sizes = [(480, 640), (640, 480), (300, 300), (256, 512), (720, 400), (224, 224),
             (333, 251), (900, 600)]
    out = []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        blocks = rng.integers(0, 256, (h // 32 + 1, w // 32 + 1, 3)).astype(np.float32)
        img = np.kron(blocks, np.ones((32, 32, 1)))[:h, :w]
        img += np.linspace(0, 60, w)[None, :, None] + rng.normal(0, 6, (h, w, 3))
        out.append(png_bytes(img.clip(0, 255).astype(np.uint8)))
    return out


def http_raw(port: int, path: str, data: bytes, ctype: str):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method="POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# A JPEG's first bytes (SOI, APP0 "JFIF", EOI) and no image: a 400.
JPEG_HEAD = bytes.fromhex("ffd8ffe000104a46494600010100000100010000ffd9")


def jpeg_bytes(png: bytes) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.open(io.BytesIO(png)).convert("RGB").save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def phase_vision_host(cm, pngs: list[bytes], reps: int = 5) -> list[float]:
    """Host ms per image of the preprocess (Pillow's decode, native resize
    + crop), the median of ``reps`` per image."""
    out = []
    for png in pngs:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            cm.servable.preprocess(png)
            times.append((time.perf_counter() - t0) * 1e3)
        out.append(statistics.median(times))
    log(f"host preprocess, ms per image, PNG bytes → uint8 224x224 crop (this machine's "
        f"CPU): {', '.join(f'{m:.3f}' for m in out)}; mean {statistics.fmean(out):.3f}")
    return out


def phase_vision_path(cfg, device: str = "cuda") -> dict:
    """Build the three vision engines, serve, and answer every body kind;
    then ``VISION_SERVED`` single raw PNGs to ResNet-50 for the served p50."""
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
    from pytorch_zappa_serverless_tpu_torch.ops import hostops
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    check(hostops.native_available(), "the native hostops library did not build or load "
                                      "(g++ missing?)")
    log(f"hostops: native library loaded from {hostops.BUILD_DIR}")
    pngs = vision_pngs()
    b64 = [base64.b64encode(p).decode() for p in pngs]
    size = cfg.models[0].extra["image_size"]
    reset_counts()
    t0 = time.perf_counter()
    engine = build_engine(cfg, device)
    log(f"vision engines ready in {time.perf_counter() - t0:.3f} s on {engine.device}: build "
        f"seconds {engine.build_seconds}; capture seconds {engine.clock.entries}")
    decoded = engine.model("resnet50").servable.preprocess(pngs[0])["image"]
    answers, gets = [], {}
    with BackgroundServer(cfg, engine) as srv:
        for name in [m.name for m in cfg.models]:
            path = f"/v1/models/{name}:predict"
            for kind, sent in (("raw", (pngs[0], "image/png")),
                               ("b64", (json.dumps({"b64": b64[0]}).encode(),
                                        "application/json")),
                               ("instances", (json.dumps({"instances": [{"b64": b} for b in b64]})
                                              .encode(), "application/json")),
                               ("array", (json.dumps(decoded.tolist()).encode(),
                                          "application/json"))):
                status, out = http_raw(srv.port, path, *sent)
                check(status == 200, f"{path} {kind}: status {status}: {out}")
                answers.append((name, kind, out))
        status, out = http_raw(srv.port, "/v1/models/resnet50:predict", jpeg_bytes(pngs[0]),
                               "image/jpeg")
        check(status == 200, f"a JPEG body: status {status}: {out}")
        answers.append(("resnet50", "jpeg", out))
        status, out = http_raw(srv.port, "/v1/models/resnet50:predict", JPEG_HEAD, "image/jpeg")
        check(status == 400, f"a JPEG head with no image: status {status}, not 400: {out}")
        log(f"a JPEG body: 200; a JPEG head with no image: 400 {out['error'][:120]}")
        launches = read_counts()  # just after the path
        lat = []
        for i in range(VISION_SERVED):
            t1 = time.perf_counter()
            status, out = http_raw(srv.port, "/v1/models/resnet50:predict", pngs[i % len(pngs)],
                                   "image/png")
            lat.append((time.perf_counter() - t1) * 1e3)
            check(status == 200, f"served request {i}: {status} {out}")
        for path in ("/healthz", "/v1/models", "/metrics"):
            status, out = http(srv.port, path)
            check(status == 200, f"{path}: status {status}: {out}")
            gets[path] = out
    return {"engine": engine, "launches": launches, "answers": answers, "gets": gets,
            "latency_ms": lat, "pngs": pngs, "size": size}


def check_vision(run: dict, classes: int = 1000, topk: int = 5) -> None:
    """Every answer well formed; per model the raw, b64 and pre-decoded
    bodies of the first image answer alike, and the instances body's first
    prediction is that answer too (bucket 8 against bucket 1: the same top-k
    indices)."""
    by = {}
    for name, kind, out in run["answers"]:
        check(out.get("model") == name and {"timing", "predictions"} <= set(out),
              f"{name} {kind}: response keys {sorted(out)}")
        preds = out["predictions"] if kind == "instances" else [out["predictions"]]
        check(len(preds) == (8 if kind == "instances" else 1), f"{name} {kind}: {len(preds)}")
        for pred in preds:
            top = pred["top_k"]
            probs = [t["prob"] for t in top]
            idx = [t["index"] for t in top]
            check(len(top) == topk and all(0.0 <= p <= 1.0 for p in probs)
                  and probs == sorted(probs, reverse=True) and sum(probs) <= 1.0 + 1e-5,
                  f"{name} {kind}: probabilities {probs}")
            check(len(set(idx)) == topk and all(0 <= i < classes for i in idx)
                  and all(t["label"] == f"class_{t['index']:04d}" for t in top),
                  f"{name} {kind}: indices {idx}")
        by[(name, kind)] = preds
    for name in {n for n, _ in by}:
        first = by[(name, "raw")][0]
        same = [by[(name, k)][0] == first for k in ("b64", "array")]
        check(all(same), f"{name}: the raw, b64 and pre-decoded bodies of one image answer "
                         f"differently")
        check([t["index"] for t in by[(name, "instances")][0]["top_k"]]
              == [t["index"] for t in first["top_k"]],
              f"{name}: the image's top-k at bucket 8 differs from bucket 1")
        log(f"{name}: raw / b64 / array / 8 instances: 200, top-1 "
            f"{first['top_k'][0]['label']} p={first['top_k'][0]['prob']:.4g}")
    health = run["gets"]["/healthz"]
    check(health["device_ok"] is True, f"/healthz: {health}")
    check(set(VISION) <= set(run["gets"]["/v1/models"]["models"]), "/v1/models misses a model")


def vision_batches(cm, pngs: list[bytes], bucket: int) -> list[tuple[str, dict]]:
    """Two collated batches that fill ``bucket``, of other images."""
    from pytorch_zappa_serverless_tpu_torch.engine.compiled import default_collate

    samples = [cm.servable.preprocess(p) for p in pngs]
    spec = cm.servable.input_spec((bucket,))
    a = [samples[i % len(samples)] for i in range(bucket)]
    b = [samples[(3 * i + 1) % len(samples)] for i in range(max(bucket - 1, 1))]
    return [(f"({bucket},) a", default_collate(a, (bucket,), spec)),
            (f"({bucket},) b", default_collate(b, (bucket,), spec))]


def vision_flops(module, size: int, device) -> int:
    """Multiply-add operations x 2 of one image through ``module``, from
    the shapes its convs and dense layers see (hooks on one eager run)."""
    from pytorch_zappa_serverless_tpu_torch.models.bert import Dense
    from pytorch_zappa_serverless_tpu_torch.models.layers import Conv

    total = []

    def conv(m, _inputs, y):
        total.append(2 * y.numel() * m.weight.shape[1] * m.kernel * m.kernel)

    def dense(m, _inputs, y):
        total.append(2 * y.numel() * m.weight.shape[1])

    hooks = [m.register_forward_hook(conv if isinstance(m, Conv) else dense)
             for m in module.modules() if isinstance(m, (Conv, Dense))]
    try:
        with torch.inference_mode():
            module(torch.zeros(1, size, size, 3, device=device))
    finally:
        for h in hooks:
            h.remove()
    return sum(total)


def phase_vision_timing(engine, size: int) -> dict:
    """Per model and bucket: device ms of one replay of the captured graph
    and of the same program run eagerly (``device_ms``: launches queued
    behind a spin kernel), beside the bf16 FLOP bound and the f32 weights'
    read bound."""
    rows = {}
    for name, cm in engine.models.items():
        m = cm.servable.module
        flops = engine.runner.run_fn_sync(vision_flops, m, size, engine.device)
        for (bucket, _), graph in sorted(cm._graphs.items()):
            def eager(g=graph):
                with torch.inference_mode():
                    cm._apply(g.inputs, None)

            replay_ms = engine.runner.run_fn_sync(device_ms, graph.captured.replay)
            eager_ms = engine.runner.run_fn_sync(device_ms, eager)
            f = flops * bucket[0]
            flop_ms = 1e3 * f / PEAK_BF16_FLOPS
            bytes_ms = 1e3 * cm.param_nbytes() / PEAK_BYTES_PER_S
            bound = max(flop_ms, bytes_ms)
            rows[(name, bucket[0])] = {"replay_ms": replay_ms, "eager_ms": eager_ms,
                                       "gflop": f / 1e9, "bound_ms": bound}
            log(f"vision {name} bucket {bucket[0]}: device ms replayed {replay_ms:.4f}, eager "
                f"{eager_ms:.4f}; {f / 1e9:.2f} GFLOP, bf16 FLOP bound {flop_ms:.5f} ms, "
                f"weights' read {bytes_ms:.5f} ms (bound by "
                f"{'operations' if flop_ms >= bytes_ms else 'bytes'}; replay at "
                f"{bound / replay_ms:.3f} of it); {1e3 * bucket[0] / replay_ms:.1f} images/s")
    return rows


def phase_vision_parity(engine, pngs: list[bytes], names=None) -> dict:
    """The served bf16 top-k (a replay at bucket 8) against an fp32 eager run
    of the same seeded weights on the card, TF32 off, for each model (of
    ``names``)."""
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig
    from pytorch_zappa_serverless_tpu_torch.models.vision_common import topk_first_index
    from pytorch_zappa_serverless_tpu_torch.ops.preprocessing import normalize_on_device
    from pytorch_zappa_serverless_tpu_torch.utils.registry import get_model_builder

    out = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in names or list(engine.models):
        cm = engine.model(name)
        (_, batch), _ = vision_batches(cm, pngs, 8)
        served = engine.runner.run_fn_sync(cm.forward, batch)["topk_packed"]
        k = served.shape[1] // 2

        def logits(module):
            with torch.inference_mode():
                x = torch.from_numpy(batch["image"]).to(engine.device)
                return module(normalize_on_device(x, module.norm_mean, module.norm_std)).float()

        def fp32_logits():  # built, run and freed on the dispatch thread
            f32 = get_model_builder(name)(ModelConfig(name=name, dtype="float32",
                                                      extra=dict(cm.cfg.extra))).module
            return logits(f32.to(engine.device))

        l16 = engine.runner.run_fn_sync(logits, cm.servable.module)
        l32 = engine.runner.run_fn_sync(fp32_logits)
        v16, i16 = topk_first_index(torch.softmax(l16, dim=-1), k)
        check(same_bits(torch.cat([v16, i16.float()], -1).cpu().numpy(), served),
              f"{name}: the served top-k is not the top-k of the eager bf16 logits")
        sigma = float(l32.std())
        moved = float((l16 - l32).abs().max()) / sigma
        lp16, lp32 = torch.log_softmax(l16, -1), torch.log_softmax(l32, -1)
        _, i32 = topk_first_index(lp32, k)
        err = (torch.gather(lp16, 1, i32) - torch.gather(lp32, 1, i32)).abs()
        tol = 2 * VISION_TAU * sigma
        share = float(err.max()) / tol
        check(share <= 1.0, f"{name}: bf16 vs fp32 log-probabilities on the fp32 top-{k}: "
                            f"{share:.3f} of the tolerance {tol:.4g}")
        top2 = torch.gather(lp32, 1, i32[:, :2])
        decided = (top2[:, 0] - top2[:, 1]) > 2 * tol
        agree = i16[:, 0] == i32[:, 0]
        n_agree, n_decided = int(agree.sum()), int(decided.sum())
        check(bool(agree[decided].all()), f"{name}: top-1 differs on a decided row")
        check(n_agree >= VISION_TOP1_MIN, f"{name}: top-1 agrees on {n_agree} of 8 rows")
        log(f"{name} bf16 vs fp32 (TF32 off) on 8 images: logits moved by up to {moved:.4f} "
            f"sigma (sigma {sigma:.4g}); max |d ln p| {float(err.max()):.4g} on the fp32 "
            f"top-{k}, {share:.3f} of the tolerance; top-1 agrees on {n_agree} of 8 rows, on "
            f"all {n_decided} decided")
        out[name] = {"share": share, "moved_sigma": moved, "agree": n_agree,
                     "decided": n_decided}
    return out


def phase_vision_profile(engine, pngs: list[bytes]) -> None:
    """``torch.profiler`` over served forwards (H2D, replay, D2H) of the
    largest ResNet-50 bucket and EfficientNet-B0 at bucket 8, eager
    (``forward_eager``) against replayed."""
    from pytorch_zappa_serverless_tpu_torch.tools import bench_fused_decode as BF

    run = engine.runner.run_fn_sync
    for name, bucket in (("resnet50", max(VISION["resnet50"])), ("efficientnet_b0", 8)):
        cm = engine.model(name)
        (_, batch), _ = vision_batches(cm, pngs, bucket)
        eager = run(BF.profile, lambda: cm.forward_eager(batch), 5)
        replay = run(BF.profile, lambda: cm.forward(batch), 5)
        log_profiles(f"{name} ({bucket},)", "forward", eager, replay, top=12)


def run_vision(profile: bool) -> dict:
    """The vision path, its checks, replay against eager, bf16 against fp32,
    and per-bucket timing."""
    fresh_memory()
    run = phase_vision_path(vision_config())
    engine = run["engine"]
    try:
        log_memory("vision", engine)
        check_vision(run)
        exact_counts(run["launches"], {}, "the vision path (it runs no kernel of the port)")
        host = phase_vision_host(engine.model("resnet50"), run["pngs"])
        lat = run["latency_ms"]
        ring = run["gets"]["/metrics"]["models"]["resnet50"]
        log(f"vision served: resnet50, {len(lat)} single raw PNGs in turn: client p50 "
            f"{statistics.median(lat):.3f} ms, p90 {float(np.percentile(lat, 90)):.3f} ms; "
            f"server total p50 {ring['total_ms']['p50']} ms, device p50 "
            f"{ring['device_ms']['p50']} ms over {ring['requests']} samples")
        for name, cm in engine.models.items():
            for b in cm.buckets:
                phase_replay(engine, name, vision_batches(cm, run["pngs"], b[0]), {})
        timing = phase_vision_timing(engine, run["size"])
        parity = phase_vision_parity(engine, run["pngs"])
        if profile:
            phase_vision_profile(engine, run["pngs"])
    finally:
        engine.shutdown()
    return {"timing": timing, "parity": parity, "p50_ms": statistics.median(lat), "host": host}


# -- phase 11: the Whisper path ---------------------------------------------------

# Full-width Whisper-tiny (d_model 384, 4 + 4 layers, vocabulary 51865, 80 x
# 3000 log-mel), seed weights, the dev profile's buckets and 64 new tokens:
# ``whisper_tiny`` on the int8 lane and ``whisper_bf16`` (the same builder)
# with f32 weights at rest.
WHISPER = {"batch_buckets": (1, 4), "max_new_tokens": 64}
WHISPER_SERVED = 20  # sequential single 3 s WAVs for the served p50
# The int8 lane's teacher-forced logits, kernel vs plain route: relative max
# error, GPT2_LOGIT_RTOL's reasons (one bf16 ulp a projection, carried on by
# the layers after it).
WHISPER_LOGIT_RTOL = 2e-2
WHISPER_FORCED = 8  # generated tokens fed after the prompt


def int8_per_call(layers: int = 4, max_new: int = WHISPER["max_new_tokens"]) -> int:
    """int8 products of one Whisper generate call: each decoder layer's eight
    projections and the lm head, at the prompt's prefill and each of the
    ``max_new`` steps (the last step's logits are computed and unused, as in
    the JAX package's scan)."""
    return (8 * layers + 1) * (1 + max_new)


def whisper_config(arch: dict | None = None, max_new_tokens: int = WHISPER["max_new_tokens"],
                   batch_buckets=WHISPER["batch_buckets"], **extra):
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig

    base = {"max_new_tokens": max_new_tokens, **({"arch": arch} if arch else {}), **extra}
    return ServeConfig(models=[
        ModelConfig(name="whisper_tiny", dtype="bfloat16", batch_buckets=tuple(batch_buckets),
                    extra={**base, "params_dtype": "int8"}),
        ModelConfig(name="whisper_bf16", builder="whisper_tiny", dtype="bfloat16",
                    batch_buckets=tuple(batch_buckets), extra=dict(base))])


def audio_signal(seconds: float, rate: int, seed: int, channels: int = 1) -> np.ndarray:
    """[n, channels] in [-1, 1]: a few tones gliding in pitch, in bursts, and
    a little noise, made from ``seed``."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    x = np.zeros_like(t)
    for _ in range(3):
        f0, glide = rng.uniform(150, 900), rng.uniform(-60, 60)
        x += rng.uniform(0.1, 0.25) * np.sin(2 * np.pi * (f0 + glide * t) * t)
    x *= 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(1, 4) * t)
    x = x[:, None] + rng.normal(0, 0.02, (t.shape[0], channels))
    return np.clip(x, -1, 1)


def wav_bytes(x: np.ndarray, rate: int) -> bytes:
    """A 16-bit PCM WAV of ``x`` [n, channels]."""
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(x.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((x * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def whisper_wavs(n: int = 4, seconds: float = 3.0, seed: int = 10) -> list[bytes]:
    return [wav_bytes(audio_signal(seconds, 16000, seed + i), 16000) for i in range(n)]


def phase_whisper_path(cfg, device: str = "cuda", served: int = WHISPER_SERVED) -> dict:
    """Build both Whisper engines, serve, and answer every body kind on the
    int8 lane (a 3 s 16 kHz WAV, a 44.1 kHz stereo WAV, ``{"array",
    "rate"}``, ``{"b64"}``, a 4-WAV ``instances`` body, a 65 s WAV) and a
    WAV on the bf16 lane; a sampling knob must answer 400; then the GETs and
    ``served`` single WAVs in turn for the served p50."""
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    wavs = whisper_wavs()
    stereo = wav_bytes(audio_signal(3.0, 44100, 20, channels=2), 44100)
    array = audio_signal(2.5, 22050, 21)[:, 0]
    long_wav = wav_bytes(audio_signal(65.0, 16000, 22), 16000)
    reset_counts()
    t0 = time.perf_counter()
    engine = build_engine(cfg, device)
    log(f"whisper engines ready in {time.perf_counter() - t0:.3f} s on {engine.device}: build "
        f"seconds {engine.build_seconds}; capture seconds {engine.clock.entries}")
    path = "/v1/models/whisper_tiny:predict"
    sends = [("wav", path, (wavs[0], "audio/wav")),
             ("stereo 44.1 kHz", path, (stereo, "audio/wav")),
             ("array", path, (json.dumps({"array": array.tolist(), "rate": 22050}).encode(),
                              "application/json")),
             ("b64", path, (json.dumps({"b64": base64.b64encode(wavs[0]).decode()}).encode(),
                            "application/json")),
             ("instances", path, (json.dumps({"instances": [
                 {"b64": base64.b64encode(w).decode()} for w in wavs]}).encode(),
                 "application/json")),
             ("65 s", path, (long_wav, "audio/wav")),
             ("bf16 wav", "/v1/models/whisper_bf16:predict", (wavs[0], "audio/wav"))]
    answers, gets = [], {}
    with BackgroundServer(cfg, engine) as srv:
        for kind, url, sent in sends:
            status, out = http_raw(srv.port, url, *sent)
            check(status == 200, f"{url} {kind}: status {status}: {out}")
            answers.append((kind, out))
        status, out = http(srv.port, path, {"array": array.tolist(), "temperature": 0.7})
        check(status == 400 and "sampling knobs" in out.get("error", ""),
              f"a sampling knob on :predict: status {status}, not 400: {out}")
        log(f"whisper {{array, temperature: 0.7}}: 400 {out['error'][:100]}")
        counts = read_counts()  # just after the path
        calls = (sum(e["model"] == "whisper_tiny" for e in engine.clock.entries)
                 + engine.runner.stats["whisper_tiny"].batches)
        lat = []
        for i in range(served):
            t1 = time.perf_counter()
            status, out = http_raw(srv.port, path, wavs[i % len(wavs)], "audio/wav")
            lat.append((time.perf_counter() - t1) * 1e3)
            check(status == 200, f"served request {i}: {status} {out}")
        for get in ("/healthz", "/v1/models", "/metrics"):
            status, out = http(srv.port, get)
            check(status == 200, f"{get}: status {status}: {out}")
            gets[get] = out
    return {"engine": engine, "counts": counts, "generate_calls": calls, "answers": answers,
            "gets": gets, "latency_ms": lat, "wavs": wavs}


def check_whisper(run: dict, vocab: int = 51865, max_new: int = WHISPER["max_new_tokens"]) -> None:
    """Every answer well formed; the raw and b64 bodies of one WAV answer
    alike and as the first instance does (bucket 4 against bucket 1); the
    65 s WAV answers three chunks."""
    by = {}
    for kind, out in run["answers"]:
        check({"model", "timing", "predictions"} <= set(out), f"whisper {kind}: keys {sorted(out)}")
        preds = out["predictions"] if kind == "instances" else [out["predictions"]]
        check(len(preds) == (4 if kind == "instances" else 1), f"whisper {kind}: {len(preds)}")
        for pred in preds:
            toks = pred["tokens"]
            limit = max_new * pred.get("chunks", 1)
            check(isinstance(toks, list) and len(toks) <= limit
                  and all(isinstance(t, int) and 0 <= t < vocab for t in toks),
                  f"whisper {kind}: tokens {toks[:20]}")
        by[kind] = preds
        log(f"whisper :predict {kind}: 200, {[len(p['tokens']) for p in preds]} tokens"
            f"{', chunks ' + str(preds[0]['chunks']) if 'chunks' in preds[0] else ''}, timing "
            f"{out['timing']}")
    check(by["65 s"][0].get("chunks") == 3
          and dict(run["answers"])["65 s"]["timing"]["samples"] == 3,
          f"the 65 s WAV: {by['65 s'][0].get('chunks')} chunks, not 3")
    check(by["wav"][0] == by["b64"][0], "the raw and b64 bodies of one WAV answer differently")
    log(f"whisper: the WAV's tokens at bucket 4 (first instance) "
        f"{'equal' if by['instances'][0] == by['wav'][0] else 'differ from'} those at bucket 1")
    check(run["gets"]["/healthz"]["device_ok"] is True, f"/healthz: {run['gets']['/healthz']}")
    check({"whisper_tiny", "whisper_bf16"} <= set(run["gets"]["/v1/models"]["models"]),
          "/v1/models misses a Whisper deployment")


def whisper_batches(cm, wavs: list[bytes], bucket: int) -> list[tuple[str, dict]]:
    """Two collated batches in ``bucket``, of other WAVs (the second one
    row short)."""
    from pytorch_zappa_serverless_tpu_torch.engine.compiled import default_collate

    samples = [cm.servable.preprocess(w) for w in wavs]
    spec = cm.servable.input_spec((bucket,))
    a = [samples[i % len(samples)] for i in range(bucket)]
    b = [samples[(i + 1) % len(samples)] for i in range(max(bucket - 1, 1))]
    return [(f"({bucket},) a", default_collate(a, (bucket,), spec)),
            (f"({bucket},) b", default_collate(b, (bucket,), spec))]


def phase_whisper_parity(engine, wavs: list[bytes], steps: int = WHISPER_FORCED) -> dict:
    """Teacher-forced logits of the served int8 model at bucket 4 (the
    prompt and ``steps`` greedy tokens of the kernel route, fed to both),
    its products through the kernel, against the same model with
    ``int8_matmul`` routed to its plain version, on the card."""
    from pytorch_zappa_serverless_tpu_torch.models import whisper as W
    from pytorch_zappa_serverless_tpu_torch.ops import int8_matmul as I

    cm = engine.model("whisper_tiny")
    cfg, dtype = cm.servable.meta["config"], cm.servable.meta["dtype"]
    (_, batch), _ = whisper_batches(cm, wavs, 4)
    served = engine.runner.run_fn_sync(cm.forward, batch)["tokens"]
    prompt = np.asarray(cm.servable.meta["prompt_ids"], np.int32)
    fed = np.concatenate([np.tile(prompt, (4, 1)), served[:, :steps]], axis=1)

    def logits(matmul):
        W.int8_mm = matmul
        try:
            with torch.inference_mode():
                tree, x = cm.servable.module.tree(), cm._place(batch)
                enc = W.encode(tree, x["mel"], cfg, dtype)
                return W.decode_forced(tree, enc, torch.from_numpy(fed).to(engine.device), cfg,
                                       dtype).cpu()
        finally:
            W.int8_mm = I.int8_matmul

    run = engine.runner.run_fn_sync
    got, want = run(logits, I.int8_matmul), run(logits, I.int8_matmul_reference)
    check(got.shape == want.shape == (4, fed.shape[1], cfg.vocab_size), f"logits {got.shape}")
    check(bool(torch.isfinite(got).all()), "whisper int8 logits are not finite")
    errs = [((got[:, t] - want[:, t]).abs().max() / want[:, t].abs().max()).item()
            for t in range(fed.shape[1])]
    check(max(errs) <= WHISPER_LOGIT_RTOL, f"whisper kernel vs plain logits: rel errs {errs}")
    # The greedy choices the served call made, from the kernel route's logits.
    P = prompt.shape[0]
    agree = (got[:, P - 1: P - 1 + steps].argmax(-1).numpy() == served[:, :steps]).mean()
    log(f"whisper parity: {fed.shape[1]} teacher-forced positions (prompt + {steps} served "
        f"tokens) at bucket 4, kernel vs plain int8_matmul: rel max err per position "
        f"{[round(e, 6) for e in errs]} (<= {WHISPER_LOGIT_RTOL}); the kernel route's argmax "
        f"equals the served token at {agree:.3f} of the fed steps")
    return {"logit_rel_err": max(errs)}


def phase_whisper_host(cm, reps: int = 5) -> dict:
    """Host ms of WAV bytes → log-mel for one 30 s window: 16 kHz mono, and
    44.1 kHz stereo (the resample on top); the median of ``reps``."""
    out = {}
    for tag, data in (("16 kHz mono", wav_bytes(audio_signal(30.0, 16000, 30), 16000)),
                      ("44.1 kHz stereo", wav_bytes(audio_signal(30.0, 44100, 31, 2), 44100))):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            cm.servable.preprocess(data)
            times.append((time.perf_counter() - t0) * 1e3)
        out[tag] = statistics.median(times)
    log(f"whisper host preprocess, ms per 30 s window, WAV bytes → [80, 3000] log-mel (this "
        f"machine's CPU): " + ", ".join(f"{k} {v:.3f}" for k, v in out.items()))
    return out


def phase_whisper_timing(engine) -> dict:
    """Per deployment and bucket: device ms of one replayed generate call and
    of the same call eager (``device_ms``), and of its encoder alone (the
    conv stem, the encoder and cross K/V, captured apart); the decoder's
    share (the prompt's prefill and 64 steps) is the difference."""
    from pytorch_zappa_serverless_tpu_torch.engine.compiled import capture
    from pytorch_zappa_serverless_tpu_torch.models import whisper as W

    rows = {}
    for name, cm in engine.models.items():
        cfg, dtype = cm.servable.meta["config"], cm.servable.meta["dtype"]
        for (bucket, _), graph in sorted(cm._graphs.items()):
            def eager(g=graph):
                with torch.inference_mode():
                    cm._apply(g.inputs, None)

            def encoder(g=graph):
                tree = cm.servable.module.tree()
                return W._cross_kv(tree, W.encode(tree, g.inputs["mel"], cfg, dtype), cfg)

            def timings(g=graph):
                with torch.inference_mode():
                    enc = capture(encoder, engine.device)
                return (device_ms(g.captured.replay), device_ms(eager, reps=3),
                        device_ms(enc.replay))

            replay_ms, eager_ms, enc_ms = engine.runner.run_fn_sync(timings)
            per_pos = (replay_ms - enc_ms) / (1 + cm.servable.meta["max_new_tokens"])
            rows[(name, bucket[0])] = {"replay_ms": replay_ms, "eager_ms": eager_ms,
                                       "encoder_ms": enc_ms, "decode_position_ms": per_pos}
            log(f"whisper {name} bucket {bucket[0]}: device ms a generate call replayed "
                f"{replay_ms:.4f}, eager {eager_ms:.4f}; encoder + cross K/V {enc_ms:.4f}, the "
                f"decoder (prefill + 64 steps) {replay_ms - enc_ms:.4f}, {per_pos:.4f} a "
                f"position; {1e3 * bucket[0] / replay_ms:.2f} windows/s")
    return rows


def phase_whisper_profile(engine, wavs: list[bytes]) -> None:
    """``torch.profiler`` over one served generate call of the int8 lane at
    bucket 4, eager against replayed, per decoder position (65)."""
    from pytorch_zappa_serverless_tpu_torch.tools import bench_fused_decode as BF

    cm = engine.model("whisper_tiny")
    (_, batch), _ = whisper_batches(cm, wavs, 4)
    run = engine.runner.run_fn_sync
    eager = run(BF.profile, lambda: cm.forward_eager(batch), 1)
    replay = run(BF.profile, lambda: cm.forward(batch), 1)
    log_profiles("whisper_tiny int8 (4,)", "position", eager, replay,
                 per=1 + WHISPER["max_new_tokens"], top=14)


def run_whisper(profile: bool) -> dict:
    """The Whisper path, its checks, replay against eager, parity, host and
    device timing; returns int8_matmul's launches on it."""
    fresh_memory()
    t0 = time.perf_counter()
    run = phase_whisper_path(whisper_config())
    engine = run["engine"]
    try:
        log_memory("whisper", engine)
        check_whisper(run)
        counts, per_call = run["counts"], int8_per_call()
        launches = counts["int8_matmul"]
        check(launches > 0, "int8_matmul was not launched on the Whisper path")
        exact_counts(counts, {"int8_matmul": per_call * run["generate_calls"]},
                     f"the Whisper path ({run['generate_calls']} int8 generate calls)")
        log(f"whisper path: {run['generate_calls']} int8 generate calls (2 captures' eager "
            f"warm-up runs, the rest served replays), int8_matmul launched {launches} times "
            f"({per_call} per call); engines and requests in {time.perf_counter() - t0:.3f} s")
        for name in ("whisper_tiny", "whisper_bf16"):
            cm = engine.model(name)
            per = {"int8_matmul": per_call} if name == "whisper_tiny" else {}
            for b in cm.buckets:
                phase_replay(engine, name, whisper_batches(cm, run["wavs"], b[0]), per)
        phase_whisper_parity(engine, run["wavs"])
        host = phase_whisper_host(engine.model("whisper_tiny"))
        lat = run["latency_ms"]
        ring = run["gets"]["/metrics"]["models"]["whisper_tiny"]
        log(f"whisper served: whisper_tiny int8, {len(lat)} single 3 s WAVs in turn: client p50 "
            f"{statistics.median(lat):.3f} ms, p90 {float(np.percentile(lat, 90)):.3f} ms; "
            f"server total p50 {ring['total_ms']['p50']} ms, device p50 "
            f"{ring['device_ms']['p50']} ms over {ring['requests']} samples")
        timing = phase_whisper_timing(engine)
        if profile:
            phase_whisper_profile(engine, run["wavs"])
    finally:
        engine.shutdown()
    return {"launches": launches, "timing": timing, "host": host,
            "p50_ms": statistics.median(lat)}


# -- phase 12: ViT-B/16 and bert_embed ----------------------------------------------

VIT_EMBED = {"vit_b16": (1, 8), "bert_embed": (1, 8)}
EMBED_SEQ = 128
# bert_embed served bf16 against an fp32 eager run (TF32 off) of the same
# weights: per element of the unit vectors, and the cosine.  The CPU
# rehearsal at full width, (8, 128), read max |d| 0.00118 and a least cosine
# of 0.999962; the limits leave ~8x and ~25x room for the card's bf16
# products.
EMBED_ATOL = 1e-2
EMBED_COS_MIN = 0.999
EMBED_NORM_TOL = 1e-5


def vit_embed_config(buckets: dict = VIT_EMBED, image_size: int = VISION_SIZE,
                     embed_arch: dict | None = None):
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig

    return ServeConfig(models=[
        ModelConfig(name="vit_b16", dtype="bfloat16", batch_buckets=buckets["vit_b16"],
                    extra={"image_size": image_size}),
        ModelConfig(name="bert_embed", dtype="bfloat16", batch_buckets=buckets["bert_embed"],
                    seq_buckets=(EMBED_SEQ,),
                    extra={"arch": embed_arch} if embed_arch else {})])


def embed_texts(n: int = 8) -> list[dict]:
    words = ("a server answers every request it is sent while the card replays one graph "
             "for each bucket of the batch").split()
    return [{"text": " ".join(words[i: i + 4 + 2 * i])} for i in range(n)]


def phase_vit_embed_path(cfg, device: str = "cuda") -> dict:
    """Build both engines, serve: ViT with a raw PNG, ``{"b64"}`` and 8 b64
    ``instances``; bert_embed with ``text``, ``input_ids`` and 8
    ``instances``; then the GETs."""
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    pngs = vision_pngs()
    b64 = [base64.b64encode(p).decode() for p in pngs]
    reset_counts()
    t0 = time.perf_counter()
    engine = build_engine(cfg, device)
    log(f"vit / bert_embed engines ready in {time.perf_counter() - t0:.3f} s on "
        f"{engine.device}: build seconds {engine.build_seconds}; capture seconds "
        f"{engine.clock.entries}")
    vit, emb = "/v1/models/vit_b16:predict", "/v1/models/bert_embed:predict"
    sends = [("vit raw", vit, (pngs[0], "image/png")),
             ("vit b64", vit, (json.dumps({"b64": b64[0]}).encode(), "application/json")),
             ("vit instances", vit, (json.dumps({"instances": [{"b64": b} for b in b64]})
                                     .encode(), "application/json")),
             ("embed text", emb, (json.dumps(embed_texts(1)[0]).encode(), "application/json")),
             ("embed input_ids", emb, (json.dumps({"input_ids": [101] + list(range(2000, 2100))
                                                   + [102]}).encode(), "application/json")),
             ("embed instances", emb, (json.dumps({"instances": embed_texts()}).encode(),
                                       "application/json"))]
    answers, gets = {}, {}
    with BackgroundServer(cfg, engine) as srv:
        for kind, url, sent in sends:
            status, out = http_raw(srv.port, url, *sent)
            check(status == 200, f"{url} {kind}: status {status}: {out}")
            answers[kind] = out
        launches = read_counts()  # just after the path
        for get in ("/healthz", "/v1/models", "/metrics"):
            status, out = http(srv.port, get)
            check(status == 200, f"{get}: status {status}: {out}")
            gets[get] = out
    return {"engine": engine, "launches": launches, "answers": answers, "gets": gets,
            "pngs": pngs}


def check_vit_embed(run: dict, classes: int = 1000, dim: int = 768) -> None:
    a = run["answers"]
    for kind in ("vit raw", "vit b64", "vit instances"):
        preds = a[kind]["predictions"] if kind.endswith("instances") else [a[kind]["predictions"]]
        check(len(preds) == (8 if kind.endswith("instances") else 1), f"{kind}: {len(preds)}")
        for pred in preds:
            probs = [t["prob"] for t in pred["top_k"]]
            check(len(probs) == 5 and probs == sorted(probs, reverse=True)
                  and all(0 <= t["index"] < classes for t in pred["top_k"]),
                  f"{kind}: top-k {pred['top_k']}")
    first = a["vit raw"]["predictions"]
    check(first == a["vit b64"]["predictions"], "vit: the raw and b64 bodies answer differently")
    check([t["index"] for t in a["vit instances"]["predictions"][0]["top_k"]]
          == [t["index"] for t in first["top_k"]], "vit: the image's top-k at bucket 8 differs")
    norms = []
    for kind in ("embed text", "embed input_ids", "embed instances"):
        preds = a[kind]["predictions"] if kind.endswith("instances") else [a[kind]["predictions"]]
        for pred in preds:
            e = np.asarray(pred["embedding"], np.float64)
            check(e.shape == (dim,) and np.isfinite(e).all(), f"{kind}: embedding {e.shape}")
            norms.append(abs(float(np.linalg.norm(e)) - 1.0))
    check(max(norms) <= EMBED_NORM_TOL, f"bert_embed: |‖e‖ - 1| up to {max(norms)}")
    check(np.allclose(a["embed text"]["predictions"]["embedding"],
                      a["embed instances"]["predictions"][0]["embedding"], rtol=0, atol=2e-2),
          "bert_embed: a text at bucket 8 embeds far from itself at bucket 1")
    log(f"vit raw / b64 / 8 instances: 200, top-1 {first['top_k'][0]['label']} "
        f"p={first['top_k'][0]['prob']:.4g}; bert_embed text / input_ids / 8 instances: 200, "
        f"{len(norms)} unit vectors of {dim}, |‖e‖ - 1| <= {max(norms):.3g}")
    check(run["gets"]["/healthz"]["device_ok"] is True, f"/healthz: {run['gets']['/healthz']}")


def embed_batches(cm, bucket: int) -> list[tuple[str, dict]]:
    from pytorch_zappa_serverless_tpu_torch.engine.compiled import default_collate

    samples = [cm.servable.preprocess(p) for p in embed_texts()]
    key = (bucket, EMBED_SEQ)
    spec = cm.servable.input_spec(key)
    return [(f"({bucket},{EMBED_SEQ}) a", default_collate(samples[:bucket], key, spec)),
            (f"({bucket},{EMBED_SEQ}) b",
             default_collate(samples[::-1][:max(bucket - 1, 1)], key, spec))]


def phase_embed_parity(engine) -> dict:
    """bert_embed served in bf16 (a replay at (8, 128)) against an fp32 eager
    run of the same seeded weights on the card, TF32 off."""
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig
    from pytorch_zappa_serverless_tpu_torch.utils.registry import get_model_builder

    cm = engine.model("bert_embed")
    (_, batch), _ = embed_batches(cm, 8)
    served = engine.runner.run_fn_sync(cm.forward, batch)["embedding"]

    def fp32():  # built, run and freed on the dispatch thread
        sv = get_model_builder("bert_embed")(ModelConfig(
            name="bert_embed", dtype="float32", seq_buckets=(EMBED_SEQ,),
            extra=dict(cm.cfg.extra)))
        sv.module.to(engine.device)
        with torch.inference_mode():
            x = {k: torch.from_numpy(v).to(engine.device) for k, v in batch.items()}
            return sv.apply_fn(sv.module, x)["embedding"].cpu().numpy()

    want = engine.runner.run_fn_sync(fp32)
    err = float(np.abs(served - want).max())
    cos = float((served * want).sum(-1).min())
    check(err <= EMBED_ATOL and cos >= EMBED_COS_MIN,
          f"bert_embed bf16 vs fp32: max |d| {err} (<= {EMBED_ATOL}), min cosine {cos} "
          f"(>= {EMBED_COS_MIN})")
    log(f"bert_embed bf16 vs fp32 (TF32 off) at (8,{EMBED_SEQ}): max |d| {err:.4g} (<= "
        f"{EMBED_ATOL}), min cosine {cos:.6f} (>= {EMBED_COS_MIN})")
    return {"max_abs": err, "min_cos": cos}


def phase_vit_embed_timing(engine) -> dict:
    """Per model and bucket: device ms of one replay and of the same program
    eager (``device_ms``)."""
    rows = {}
    for name, cm in engine.models.items():
        for (bucket, _), graph in sorted(cm._graphs.items()):
            def eager(g=graph):
                with torch.inference_mode():
                    cm._apply(g.inputs, None)

            replay_ms = engine.runner.run_fn_sync(device_ms, graph.captured.replay)
            eager_ms = engine.runner.run_fn_sync(device_ms, eager)
            rows[(name, bucket)] = {"replay_ms": replay_ms, "eager_ms": eager_ms}
            log(f"{name} bucket {bucket}: device ms replayed {replay_ms:.4f}, eager "
                f"{eager_ms:.4f}; {1e3 * bucket[0] / replay_ms:.1f} inputs/s")
    return rows


def run_vit_embed(profile: bool) -> dict:
    """ViT-B/16 and bert_embed: served bodies, no kernel of the port, replay
    against eager, bf16 against fp32, per-bucket device ms."""
    fresh_memory()
    run = phase_vit_embed_path(vit_embed_config())
    engine = run["engine"]
    try:
        log_memory("vit / bert_embed", engine)
        check_vit_embed(run)
        exact_counts(run["launches"], {}, "ViT and bert_embed (they run no kernel of the port)")
        vit = engine.model("vit_b16")
        for b in vit.buckets:
            phase_replay(engine, "vit_b16", vision_batches(vit, run["pngs"], b[0]), {})
        emb = engine.model("bert_embed")
        for b in emb.buckets:
            phase_replay(engine, "bert_embed", embed_batches(emb, b[0]), {})
        vit_parity = phase_vision_parity(engine, run["pngs"], names=["vit_b16"])
        embed_parity = phase_embed_parity(engine)
        timing = phase_vit_embed_timing(engine)
        if profile:
            from pytorch_zappa_serverless_tpu_torch.tools import bench_fused_decode as BF

            (_, batch), _ = vision_batches(vit, run["pngs"], 8)
            log_profiles("vit_b16 (8,)", "forward",
                         engine.runner.run_fn_sync(BF.profile, lambda: vit.forward_eager(batch), 5),
                         engine.runner.run_fn_sync(BF.profile, lambda: vit.forward(batch), 5))
    finally:
        engine.shutdown()
    return {"timing": timing, "vit_parity": vit_parity, "embed_parity": embed_parity}


# -- phase 13: the :generate lane ---------------------------------------------------

# Full-width GPT-2 small (seed weights) on three :generate lanes of one
# server: ``gpt2`` int8 on the slot pool, ``gpt2_paged`` bf16 on the paged
# pool with chunked prefill and the prefix cache, and ``gpt2_tight``, the
# same bf16 weights on a page pool of one full sequence, which must evict and
# shed; and Whisper-tiny int8 on the slot pool.
# 48 new tokens, so that the whole script stays within half its time limit.
GEN = {"seq_buckets": (16, 64, 128), "max_new_tokens": 48, "gen_slots": 8,
       "segment_tokens": 8, "block_size": 16, "chunk": 64}
GEN_STREAMS = 16
# Timed bursts a GPT-2 lane serves after one that wakes the server: the
# first is held against the fixed route, all give the spread of the
# served figures.
GEN_BURSTS = 2
GEN_SAMPLED = {"temperature": 0.8, "top_k": 40, "top_p": 0.95}
GEN_WHISPER = {"gen_slots": 4, "streams": 4}
# Streams of a lane whose teacher-forced steps are also run at the lane's
# shapes to measure its logit error (the rest run the fixed route's only).
ERR_STREAMS = 6
# Limits that keep the margin rule from passing a faulty lane: a fault in
# the lane's shapes would raise its logit error and leave most positions
# undecided.  The card read errors of 0.0155-0.0333 and decided shares of
# 61-96 % a lane (PERF.md §2).
ERR_LIMIT = 0.1
DECIDED_MIN = 0.5
# The same limit for the decisions of a sampled speculative stream
# (:func:`spec_replay`), which are all draws and verdicts: with GPT-2's
# near-flat seeded logits at T 0.8, a draw's winner is one of the ~10
# top-40 tokens the filter may drop in about a quarter of the draws, and a
# residual max(p - q, 0) of a draft that close to its target lies inside
# the error band.  The card's decisions decided 0.49-0.52 (PERF.md §2).
SPEC_DECIDED_MIN = 0.4


def generate_config(arch: dict | None = None, whisper_arch: dict | None = None,
                    max_new_tokens: int = GEN["max_new_tokens"], **extra):
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig

    seq = GEN["seq_buckets"]
    lane = {"max_new_tokens": max_new_tokens, "gen_slots": GEN["gen_slots"],
            "segment_tokens": GEN["segment_tokens"], **({"arch": arch} if arch else {})}
    paged = {"kv_cache": "paged", "kv_block_size": GEN["block_size"],
             "prefill_chunk_tokens": GEN["chunk"]}
    tight = -(-(seq[-1] + max_new_tokens) // GEN["block_size"]) + 1  # one sequence + trash
    return ServeConfig(models=[
        ModelConfig(name="gpt2", dtype="bfloat16", batch_buckets=(1,), seq_buckets=seq,
                    extra={**lane, "params_dtype": "int8", **extra}),
        ModelConfig(name="gpt2_paged", builder="gpt2", dtype="bfloat16", batch_buckets=(1,),
                    seq_buckets=seq, **paged, extra={**lane, "params_dtype": "bfloat16"}),
        # kv_migrate off: the eviction ladder alone (phase 17 swaps to host).
        ModelConfig(name="gpt2_tight", builder="gpt2", dtype="bfloat16", batch_buckets=(1,),
                    seq_buckets=seq[-1:], **paged, kv_num_blocks=tight, prefix_cache=False,
                    kv_migrate=False, extra={**lane, "params_dtype": "bfloat16", "gen_slots": 2}),
        ModelConfig(name="whisper_tiny", dtype="bfloat16", batch_buckets=(1, 4),
                    extra={"max_new_tokens": max_new_tokens, "params_dtype": "int8",
                           "gen_slots": GEN_WHISPER["gen_slots"],
                           "segment_tokens": GEN["segment_tokens"],
                           **({"arch": whisper_arch} if whisper_arch else {}), **extra})])


def sse(port: int, model: str, body, timeout: float = 600.0, headers: dict | None = None) -> dict:
    """One ``:generate`` request: a JSON body (or raw bytes) posted, the
    event stream read as it comes; each token's client time from the send."""
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    ctype = "application/octet-stream" if isinstance(body, bytes) else "application/json"
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/models/{model}:generate",
                                 data=data, headers={"Content-Type": ctype, **(headers or {})})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            if not r.headers.get("Content-Type", "").startswith("text/event-stream"):
                return {"status": r.status, "body": json.loads(r.read()),
                        "headers": dict(r.headers), "wall": time.perf_counter() - t0}
            toks, times, final = [], [], None
            for line in r:
                if not line.startswith(b"data: "):
                    continue
                ev = json.loads(line[6:])
                if "token" in ev:
                    toks.append(ev["token"])
                    times.append(time.perf_counter() - t0)
                else:
                    final = ev
            return {"status": r.status, "tokens": toks, "times": times, "final": final,
                    "headers": dict(r.headers), "wall": time.perf_counter() - t0}
    except urllib.error.HTTPError as e:
        return {"status": e.code, "body": json.loads(e.read()), "headers": dict(e.headers)}


def gen_bodies(n: int = GEN_STREAMS, seed: int = 13, vocab: int = 50257,
               max_prompt: int = 120, max_new: int = GEN["max_new_tokens"]) -> list[dict]:
    """``n`` requests: prompts of 5 to ``max_prompt`` token ids and budgets of
    8 to ``max_new`` tokens, every other one sampled with top-k and top-p."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        body = {"input_ids": rng.integers(0, vocab - 1, int(rng.integers(5, max_prompt + 1)))
                .tolist(), "max_new_tokens": int(rng.integers(8, max_new + 1))}
        if i % 2:
            body.update(GEN_SAMPLED, seed=int(rng.integers(0, 1 << 16)))
        out.append(body)
    return out


def gen_burst(port: int, model: str, bodies: list,
              headers: list | None = None) -> tuple[list[dict], float]:
    """Every body at once, one thread each (with its ``headers``, where
    given); the results and the wall time."""
    t0 = time.perf_counter()
    heads = headers or [None] * len(bodies)
    with ThreadPoolExecutor(len(bodies)) as ex:
        results = list(ex.map(lambda bh: sse(port, model, bh[0], headers=bh[1]),
                              zip(bodies, heads)))
    return results, time.perf_counter() - t0


def stream_stats(results: list[dict], wall: float) -> dict:
    """Client-side TTFT (send → first token event) and inter-token gaps of
    the streamed results, and tokens/s over the burst."""
    streams = [r for r in results if r["status"] == 200 and "times" in r and r["times"]]
    ttft = [r["times"][0] * 1e3 for r in streams]
    itl = [1e3 * (b - a) for r in streams for a, b in zip(r["times"], r["times"][1:])]
    toks = sum(len(r["tokens"]) for r in streams)
    return {"streams": len(streams), "tokens": toks, "wall_s": wall,
            "tok_per_s": toks / wall if wall else 0.0,
            "ttft_p50": float(np.percentile(ttft, 50)), "ttft_p99": float(np.percentile(ttft, 99)),
            "itl_p50": float(np.percentile(itl, 50)) if itl else 0.0,
            "itl_p99": float(np.percentile(itl, 99)) if itl else 0.0}


def route_trees(cm, rows: int, aidx: int = 0):
    """(prefill tree, decode tree, adapter_idx) of GPT-2's fixed route at
    ``rows`` decode rows: the regime-routed lane's bf16 prefill and its
    decode tree for that row count, and the rows' adapter slot where the
    model has an adapter pool (None otherwise)."""
    meta, tree = cm.servable.meta, cm.servable.module.tree()
    ai = (torch.full((rows,), aidx, dtype=torch.int32, device=cm.device)
          if meta.get("adapters") else None)
    return meta["pre_tree"](tree), meta["dec_tree"](tree, rows), ai


def gpt2_chains(cm, ids: list[int], toks: list[int], n: int, rows: int,
                total: int | None = None, aidx: int = 0) -> torch.Tensor:
    """Teacher-forced logits [n, V] of one stream through the fixed route's
    functions at ``rows`` rows (the stream's row repeated, at adapter slot
    ``aidx``) and a cache of ``total`` positions (the route's own by
    default): the prompt's prefill in its seq bucket, then a decode step for
    each of ``toks[:n-1]`` fed in turn.  Row i is the logits token i is
    chosen from."""
    from pytorch_zappa_serverless_tpu_torch.models import gpt2 as G

    meta, dev = cm.servable.meta, cm.device
    cfg, dtype = meta["config"], meta["dtype"]
    pre, dec, ai = route_trees(cm, rows, aidx)
    P = cm.bucket_for(1, len(ids))[1]
    x = torch.zeros((rows, P), dtype=torch.int32, device=dev)
    x[:, :len(ids)] = torch.tensor(ids, dtype=torch.int32, device=dev)
    pos = torch.full((rows,), len(ids), dtype=torch.int32, device=dev)
    logits, ck, cv = G.prefill(pre, x, pos, total or P + n, cfg, dtype, adapter_idx=ai)
    out = [logits[0]]
    for t in toks[: n - 1]:
        logits = G.decode_step(dec, ck, cv, torch.full((rows,), t, dtype=torch.int32,
                                                       device=dev), pos, cfg, dtype,
                               adapter_idx=ai)
        out.append(logits[0])
        pos = pos + 1
    return torch.stack(out).float().cpu()


def chunked_chains(cm, ids: list[int], toks: list[int], n: int, rows: int, chunk: int,
                   block: int, aidx: int = 0) -> torch.Tensor:
    """:func:`gpt2_chains` with the paged lane's prefill: the prompt in the
    lane's chunk plan (``chunk``-token chunks, the last one padded to a
    power of two from 8) for ``rows`` rows through ``prefill_chunk_logits``
    (the lane's chunk up to its first-token logits) over a scratch page
    pool, the last chunk's logits kept; then the decode steps over the
    gathered pages."""
    from pytorch_zappa_serverless_tpu_torch.models import gpt2 as G
    from pytorch_zappa_serverless_tpu_torch.ops.paged_attention import gather_kv

    meta, dev = cm.servable.meta, cm.device
    cfg, dtype = meta["config"], meta["dtype"]
    pre, dec, ai = route_trees(cm, rows, aidx)
    MB = -(-meta["continuous"]["total"] // block)
    ck = torch.zeros((cfg.layers, rows * MB + 1, block, cfg.d_model), dtype=dtype, device=dev)
    cv = torch.zeros_like(ck)
    table = (torch.arange(rows * MB, device=dev, dtype=torch.int32) + 1).view(rows, MB)
    full = lambda v, dt=torch.int32: torch.full((rows,), v, dtype=dt, device=dev)  # noqa: E731
    start, L = 0, len(ids)
    while start < L:
        C = chunk
        if L - start <= chunk:
            C = 8
            while C < L - start:
                C *= 2
            C = min(C, chunk)
        x = torch.zeros((rows, C), dtype=torch.int32, device=dev)
        part = ids[start:start + C]
        x[:, :len(part)] = torch.tensor(part, dtype=torch.int32, device=dev)
        logits = G.prefill_chunk_logits(pre, x, full(start), full(L), ck, cv, table, block,
                                        cfg, dtype, adapter_idx=ai)
        start += C
    k = torch.stack([gather_kv(ck[i], table) for i in range(cfg.layers)])
    v = torch.stack([gather_kv(cv[i], table) for i in range(cfg.layers)])
    out, pos = [logits[0]], full(L)
    for t in toks[: n - 1]:
        out.append(G.decode_step(dec, k, v, full(t), pos, cfg, dtype, adapter_idx=ai)[0])
        pos = pos + 1
    return torch.stack(out).float().cpu()


def whisper_chains(cm, mel: np.ndarray, toks: list[int], n: int, rows: int) -> torch.Tensor:
    """The same for one Whisper stream: the encoder, cross K/V and the task
    prompt at ``rows`` rows (the window repeated), then greedy steps fed
    ``toks``: the :predict route's functions."""
    from pytorch_zappa_serverless_tpu_torch.models import whisper as W

    meta, dev = cm.servable.meta, cm.device
    tree, cfg, dtype = cm.servable.module.tree(), meta["config"], meta["dtype"]
    m = torch.from_numpy(mel).to(dev)[None].expand(rows, -1, -1).contiguous()
    cross = W._cross_kv(tree, W.encode(tree, m, cfg, dtype), cfg)
    prompt = torch.tensor(meta["prompt_ids"], dtype=torch.int32, device=dev)[None]
    P, total = prompt.shape[1], prompt.shape[1] + n
    logits, ck, cv = W.prefill_decoder(tree, cross, prompt.expand(rows, -1), total, cfg, dtype)
    out = [logits[0]]
    for i, t in enumerate(toks[: n - 1]):
        logits = W._decoder_step(tree, cfg, dtype, cross,
                                 torch.full((rows,), t, dtype=torch.int32, device=dev), P + i,
                                 ck, cv, W._kpos_mask(total, P + i, dev))
        out.append(logits[0])
    return torch.stack(out).float().cpu()


def sample_candidates(s: torch.Tensor, top_k: int, top_p: float, e: float):
    """The filter of ``ops.sampling.filter_top_k_top_p`` on tempered logits
    ``s`` [V] when each may be off by up to ``e``: (the tokens surely kept,
    the tokens that may be kept).  Top-k keeps a token surely when it leads
    the (k+1)-th by more than 2e; top-p keeps the i-th surely when its
    preceding mass, scaled by exp(2e) (the most any probability can move),
    is still within ``top_p``."""
    V = s.shape[0]
    desc, order = torch.sort(s, descending=True)
    k = V if top_k <= 0 else min(top_k, V)
    nxt = desc[k] if k < V else torch.tensor(-float("inf"))
    sure = s > nxt + 2 * e
    maybe = s >= desc[k - 1] - 2 * e
    if top_p < 1.0:
        probs = torch.softmax(desc[:k].double(), 0)
        cum_prev = torch.cumsum(probs, 0) - probs
        in_sure = torch.zeros(V, dtype=torch.bool)
        in_maybe = torch.ones(V, dtype=torch.bool)
        in_sure[order[:k]] = (cum_prev * np.exp(2 * e)) <= top_p
        in_sure[order[0]] = True  # the filter keeps one token at least
        in_maybe[order[:k]] = (cum_prev * np.exp(-2 * e)) <= top_p
        in_maybe[order[0]] = True
        sure, maybe = sure & in_sure, maybe & in_maybe
    return sure, maybe | sure


def hold_stream(ref: torch.Tensor, err: torch.Tensor, tokens: list[int], knobs: dict,
                support: bool = False) -> dict:
    """One stream held against the fixed route's teacher-forced logits
    ``ref`` [n, V] under the margin rule: at each position the stream's token
    must be the route's choice wherever that choice is decided by more than
    twice the step's logit error ``err``.  Greedy: the top-2 margin of the
    logits.  Sampled: the same (seed, step) Gumbel draw over the tempered
    logits (error divided by T), where the choice must be surely inside the
    top-k / top-p filter and lead every token that may be inside it by more
    than twice the error.  With ``support`` a sampled token is held to the
    filter alone (an evicted stream prefilled again draws its next token at
    step 0 again, at a point its tokens do not show): it must be a token
    that may be inside the top-k / top-p filter, and it is decided where
    surely inside.
    Returns the counts and the positions where it fails."""
    from pytorch_zappa_serverless_tpu_torch.ops import sampling as PS

    temp = max(float(knobs.get("temperature", 0.0)), 0.0)
    top_k, top_p = int(knobs.get("top_k", 0)), float(knobs.get("top_p", 1.0))
    V = ref.shape[1]
    out = {"decided": 0, "undecided": 0, "agree_undecided": 0, "fail": []}
    for i, tok in enumerate(tokens):
        e = float(err[i])
        if temp > 0 and support:
            s = ref[i] / max(temp, 1e-3)
            sure, maybe = sample_candidates(s, top_k, top_p, e / max(temp, 1e-3))
            if not bool(maybe[tok]):
                out["fail"].append((i, tok, "outside the filter", e))
            if bool(sure[tok]):
                out["decided"] += 1
            else:
                out["undecided"] += 1
                out["agree_undecided"] += int(bool(maybe[tok]))
            continue
        if temp > 0:
            s = ref[i] / max(temp, 1e-3)
            e = e / max(temp, 1e-3)
            sure, maybe = sample_candidates(s, top_k, top_p, e)
            kept = PS.filter_top_k_top_p(s[None], torch.tensor([top_k]),
                                         torch.tensor([top_p]))[0]
            g = PS.gumbel_noise(torch.tensor([int(knobs.get("seed", 0))]), torch.tensor([i]), V,
                                torch.device("cpu"))[0]
            choice = int((kept + g).argmax())
            v = s + g
            rivals = v.masked_fill(~maybe, -float("inf"))
            rivals[choice] = -float("inf")
            margin = float(v[choice] - rivals.max()) if bool(sure[choice]) else 0.0
        else:
            top2 = ref[i].topk(2).values
            choice, margin = int(ref[i].argmax()), float(top2[0] - top2[1])
        if margin > 2 * e:
            out["decided"] += 1
            if choice != tok:
                out["fail"].append((i, tok, choice, margin, e))
        else:
            out["undecided"] += 1
            out["agree_undecided"] += int(choice == tok)
    return out


def stream_refs(engine, name: str, streams: list[dict], rows: int,
                paged: tuple[int, int] | None = None,
                err: float | None = None) -> tuple[list, float]:
    """Each finished stream's teacher-forced logits through the fixed
    route, and the lane's logit error: the largest difference between the
    route's logits at its own row count (one request: 1) and cache, and the
    same step at the lane's (``rows``, the pool's decode rows, and the
    pool's cache), where the int8 plan and cuBLAS's algorithm change; for a
    paged lane (``paged`` = (chunk, page size)) also at the lane's chunked
    prefill over pages (:func:`chunked_chains`), where a prefill's rows
    change; the largest such difference over the lane's first
    ``ERR_STREAMS`` streams serves every step.  ``err`` is the lane's error
    measured by an earlier call on the same lane's shapes: given, no step is
    run at the lane's shapes again.  Returns ([(tokens, logits [n, V]), ...],
    the error)."""
    cm = engine.model(name)
    eos = cm.servable.meta["continuous"]["eos_id"]
    whisper = "mel" in streams[0]

    def chains():
        with torch.inference_mode():
            res = []
            for i, s in enumerate(streams):
                toks = list(s["tokens"]) + ([eos] if s["ended"] else [])
                n, key = len(toks), s["mel"] if whisper else s["ids"]
                aidx = {} if whisper else {"aidx": s.get("aidx", 0)}
                ref = (whisper_chains if whisper else gpt2_chains)(cm, key, toks, n, 1, **aidx)
                check(bool(torch.isfinite(ref).all()), f"{name}: reference logits not finite")
                e = 0.0
                if err is None and i < ERR_STREAMS:  # measured on the lane's first streams
                    lane = (whisper_chains(cm, key, toks, n, rows) if whisper else
                            gpt2_chains(cm, key, toks, n, rows,  # the pool's cache
                                        cm.servable.meta["continuous"]["total"], **aidx))
                    e = float((lane - ref).abs().max())
                    if paged:
                        chunked = chunked_chains(cm, key, toks, n, rows, *paged, **aidx)
                        e = max(e, float((chunked - ref).abs().max()))
                res.append((toks, ref, e))
            return res

    res = engine.runner.run_fn_sync(chains)
    # One error for every step of the lane: the largest any step showed
    # across its streams (a step's own can miss a shape the lane ran).
    err_max = err if err is not None else max(e for _, _, e in res)
    return [(toks, ref) for toks, ref, _ in res], err_max


def hold_streams(engine, name: str, streams: list[dict], rows: int,
                 paged: tuple[int, int] | None = None, support: bool = False,
                 keep_refs: bool = False, err: float | None = None) -> dict:
    """Every finished stream of a lane held against the fixed route's
    teacher-forced logits under the margin rule of :func:`hold_stream`, with
    the lane's logit error of :func:`stream_refs` (``rows``, ``paged`` and
    ``err`` as there).  Fails at any decided position that disagrees, when
    the error passes ``ERR_LIMIT`` or the decided share falls under
    ``DECIDED_MIN``; prints the positions outside the rule.  ``support``
    holds sampled streams to the filter alone (:func:`hold_stream`).  With
    ``keep_refs`` the teacher-forced logits stay in the result (``refs``:
    each stream's tokens and logits)."""
    refs, err_max = stream_refs(engine, name, streams, rows, paged, err)
    total = {"streams": len(streams), "decided": 0, "undecided": 0, "agree_undecided": 0,
             "fail": [], "err_max": err_max}
    for s, (toks, ref) in zip(streams, refs):
        got = hold_stream(ref, torch.full((len(toks),), err_max), toks, s.get("knobs", {}),
                          support)
        for k in ("decided", "undecided", "agree_undecided"):
            total[k] += got[k]
        total["fail"] += [(s.get("tag", "?"), *f) for f in got["fail"]]
    total["decided_share"] = total["decided"] / max(total["decided"] + total["undecided"], 1)
    log(f"{name}: {total['streams']} streams held against the fixed route: "
        f"{total['decided']} positions decided ({len(total['fail'])} disagree), "
        f"{total['undecided']} outside the margin rule ({total['agree_undecided']} of them agree "
        f"anyway), a decided share of {total['decided_share']:.3f} (at least {DECIDED_MIN}); "
        f"the lane's logit error {total['err_max']:.4g} (at most {ERR_LIMIT})")
    check(not total["fail"], f"{name}: stream tokens differ from the fixed route where the "
                             f"margin exceeds twice the logit error: {total['fail'][:8]}")
    check(err_max <= ERR_LIMIT, f"{name}: the lane's logit error {err_max:.4g} exceeds "
                                f"{ERR_LIMIT}")
    check(total["decided_share"] >= DECIDED_MIN,
          f"{name}: the margin rule decides {total['decided_share']:.3f} of the positions, "
          f"under {DECIDED_MIN}")
    if keep_refs:
        total["refs"] = refs
    return total


def filtered_bounds(s: torch.Tensor, top_k: int, top_p: float, e: float):
    """Bounds of the filtered softmax of tempered logits ``s`` [V] when each
    may be off by up to ``e``: (p_lo, p_hi) [V] f64 and the filter's (sure,
    maybe) of :func:`sample_candidates`.  A token's weight moves by at most
    exp(e).  The kept set's normaliser Z holds every sure token and lies in
    the maybe set; top-k keeps k tokens, so Z is at most exp(e) times the k
    largest weights' sum Z_k, and top-p keeps more than ``top_p`` of its
    top-k set's mass, so Z is at least exp(-e) top_p Z_k."""
    sure, maybe = sample_candidates(s, top_k, top_p, e)
    w = torch.exp(s.double() - float(s.max()))
    k = w.shape[0] if top_k <= 0 else min(top_k, w.shape[0])
    z_k = float(w.topk(k).values.sum())
    z_lo = np.exp(-e) * max(float(w[sure].sum()), min(top_p, 1.0) * z_k)
    z_hi = np.exp(e) * min(float(w[maybe].sum()), z_k)
    zero = torch.zeros_like(w)
    return (torch.where(sure, w * np.exp(-e) / z_hi, zero),
            torch.where(maybe, w * np.exp(e) / z_lo, zero), sure, maybe)


def gumbel_draw(v: torch.Tensor, sure: torch.Tensor, maybe: torch.Tensor,
                e: float) -> tuple[int | None, torch.Tensor]:
    """The filtered Gumbel-max draw ``argmax(kept(s) + g)`` with ``v = s +
    g`` when each ``s`` may be off by up to ``e``: (the choice where
    decided, else None; the tokens that may be chosen).  Decided: surely
    kept and ahead of every token that may be kept by more than 2e."""
    top = float(v.masked_fill(~sure, -float("inf")).max())
    cand = maybe & (v + 2 * e >= top)
    c = int(v.masked_fill(~sure, -float("inf")).argmax())
    rivals = v.masked_fill(~maybe, -float("inf"))
    rivals[c] = -float("inf")
    return (c if float(v[c] - rivals.max()) > 2 * e else None), cand


def log_draw(lo: torch.Tensor, hi: torch.Tensor,
             g: torch.Tensor) -> tuple[int | None, torch.Tensor]:
    """The draw ``argmax(log r + g)`` from weights ``r`` known to lie in
    [``lo``, ``hi``] (f64): (the choice where decided, else None; the tokens
    that may be chosen)."""
    g = g.double()
    a_lo, a_hi = torch.log(lo) + g, torch.log(hi) + g  # -inf where the weight is 0
    best_lo = float(a_lo.max())
    cand = a_hi >= best_lo
    c = int(a_lo.argmax())
    if best_lo == -float("inf"):
        return None, cand
    rivals = a_hi.clone()
    rivals[c] = -float("inf")
    return (c if best_lo > float(rivals.max()) else None), cand


class SpecTicks:
    """Record every speculative tick of the paged lane ``sched`` while the
    ``with`` block runs, as the lane fans it out: for each active stream
    (keyed by its prompt ids) its pending token and step, the tick's
    proposals (as verified: shifted under ``spec_mismatch``), the accepted
    count and the next pending token.  It observes only: the lane's own
    fan-out runs unchanged."""

    def __init__(self, sched):
        self.sched, self.ticks = sched, {}

    def __enter__(self):
        sched, orig = self.sched, self.sched._distribute_spec

        def recorded(n, out, props):
            for slot, req in sched._active.items():
                key = tuple(int(x) for x in sched._prompt_ids(req.sample))
                k = int(n[slot])
                self.ticks.setdefault(key, []).append(
                    {"tok": int(sched._tok[slot]), "step": int(sched._step[slot]),
                     "props": [int(x) for x in props[slot]], "n": k, "next": int(out[slot, k])})
            return orig(n, out, props)

        sched._distribute_spec = recorded
        return self

    def __exit__(self, *exc):
        del self.sched._distribute_spec  # the class's own again
        return False


def spec_replay(ref_t: torch.Tensor, ref_d: torch.Tensor, toks: list[int], ticks: list[dict],
                knobs: dict, e_t: float, e_d: float, mismatch_eos: int | None = None) -> dict:
    """One sampled speculative stream's recorded ticks (:class:`SpecTicks`)
    replayed: the rejection sampling of
    ``ops.sampling.speculative_verify_core`` (Leviathan et al.) on the
    target's and the draft's teacher-forced logits along the stream
    (``ref_t``, ``ref_d`` [n, V]: row i is the logits token i is chosen
    from) with the lane's draws, every decision under the margin rule: the
    logits may be off by up to ``e_t`` (the target) and ``e_d`` (the
    draft).

    The first token is the prefill's plain draw at step 0.  A tick whose
    pending token is token j (step j) proposes tokens j+1..j+K: proposal i
    is the draft's draw at step j+1+i (``mismatch_eos``: shifted by one, as
    the ``spec_mismatch`` fault does); the tick accepts its first n
    (u·q(d) < p(d), ``spec_draws`` at step j), and token j+n+1 is the
    residual draw from max(p - q, 0) at a rejection, else the bonus draw
    from p.  The ticks must follow each other over the whole stream and
    emit its tokens.  The draft's logits are known where its context is the
    stream's: every proposal up to the first rejection, and under the fault
    only up to the first acceptance (the draft drew on after its own,
    unshifted token); past that a decision is counted undecided.  Decided:
    where the bounds of :func:`filtered_bounds` settle it; a decided draw or
    verdict that differs from the lane's fails the stream.  Returns the
    counts of decisions (draft draws, verdicts, target draws), the first
    failure, and the residual mass sum(max(p - q, 0)) at each rejection."""
    from pytorch_zappa_serverless_tpu_torch.ops import sampling as PS

    temp = max(float(knobs["temperature"]), 1e-3)
    top_k, top_p = int(knobs.get("top_k", 0)), float(knobs.get("top_p", 1.0))
    seed = int(knobs.get("seed", 0))
    n_toks, V = len(toks), ref_t.shape[1]
    et, ed = e_t / temp, e_d / temp
    cpu = torch.device("cpu")
    out = {"decided": 0, "undecided": 0, "fail": None, "mass": [],
           "kinds": {"draft": [0, 0], "verdict": [0, 0], "draw": [0, 0]}}

    def bounds(ref, P, e):
        s = ref[P].float() / temp
        return (s, *filtered_bounds(s, top_k, top_p, e))

    def noise(sd, step, salt=None):
        return PS.gumbel_noise(torch.tensor([sd]), torch.tensor([step]), V, cpu, salt)[0]

    def count(kind, decided):
        out["decided" if decided else "undecided"] += 1
        out["kinds"][kind][0 if decided else 1] += 1

    def fail(P, why):
        out["fail"] = (P, why)
        return out

    def target_draw(P, g, what):
        s, _, _, sure, maybe = bounds(ref_t, P, et)
        c, cand = gumbel_draw(s + g, sure, maybe, et)
        if not bool(cand[toks[P]]) or (c is not None and c != toks[P]):
            return f"{what}: the lane drew {toks[P]}, the rule {c}"
        count("draw", c is not None)
        return None

    why = target_draw(0, noise(seed, 0), "the prefill's draw at step 0")
    if why:
        return fail(0, why)
    shift = (lambda x: x) if mismatch_eos is None else \
        (lambda x: (x + 1) % max(mismatch_eos, 2))  # noqa: E731
    j = 0
    for t in ticks:
        if t["step"] != j or j >= n_toks or toks[j] != t["tok"]:
            return fail(j, f"a tick at step {t['step']} pending {t['tok']} where the stream "
                           f"is at {j} ({toks[j] if j < n_toks else None})")
        K, n, props = len(t["props"]), t["n"], t["props"]
        emitted = props[:n] + [t["next"]]
        if toks[j + 1:j + 2 + n] != emitted[:n_toks - j - 1]:
            return fail(j + 1, f"the tick emitted {emitted}, the stream {toks[j + 1:j + 2 + n]}")
        u = (PS.uniform_bits(torch.tensor([seed]), torch.tensor([j]), K, PS.ACCEPT_SALT)[0]
             .double() * 2.0 ** -24).tolist()
        for i in range(min(n + 1, K)):
            P = j + 1 + i
            if P >= n_toks:
                break
            if mismatch_eos is not None and i > 0:  # the draft drew after its own token
                count("draft", False)
                count("verdict", False)
                continue
            s_d, q_lo, q_hi, sure_d, maybe_d = bounds(ref_d, P, ed)
            c, cand = gumbel_draw(s_d + noise(seed ^ PS.DRAFT_SEED_SALT, P), sure_d, maybe_d, ed)
            if not any(shift(x) == props[i] for x in cand.nonzero().flatten().tolist()) or \
                    (c is not None and shift(c) != props[i]):
                return fail(P, f"proposal {i} at step {P}: the lane proposed {props[i]}, the "
                               f"draft's draw is {c}")
            count("draft", c is not None)
            _, p_lo, p_hi, _, _ = bounds(ref_t, P, et)
            d = props[i]
            sure_acc = u[i] * float(q_hi[d]) < float(p_lo[d])
            sure_rej = u[i] * float(q_lo[d]) >= float(p_hi[d])
            if (i < n and sure_rej) or (i == n and sure_acc):
                return fail(P, f"proposal {i} ({d}) {'accepted' if i < n else 'rejected'} where "
                               f"the verdict is decided the other way (u {u[i]:.4f})")
            count("verdict", sure_acc if i < n else sure_rej)
        P = j + 1 + n
        if P < n_toks:
            if n == K:
                why = target_draw(P, noise(seed, j, PS.BONUS_SALT), f"the bonus at step {j}")
            elif mismatch_eos is not None and n > 0:
                count("draw", False)
                why = None
            else:
                _, p_lo, p_hi, _, _ = bounds(ref_t, P, et)
                _, q_lo, q_hi, _, _ = bounds(ref_d, P, ed)
                r_lo, r_hi = (p_lo - q_hi).clamp_min(0.0), (p_hi - q_lo).clamp_min(0.0)
                g = noise(seed, j, PS.RESIDUAL_SALT ^ (n << 16))
                if float(r_lo.sum()) <= 1e-9:  # the residual may vanish: then p itself
                    s, _, _, sure, maybe = bounds(ref_t, P, et)
                    c, cand = None, gumbel_draw(s + g, sure, maybe, et)[1] | \
                        log_draw(r_lo, r_hi, g)[1]
                else:
                    c, cand = log_draw(r_lo, r_hi, g)
                if not bool(cand[toks[P]]) or (c is not None and c != toks[P]):
                    why = f"the residual at step {j}, proposal {n}: the lane drew {toks[P]}, " \
                          f"the rule {c}"
                else:
                    why = None
                    count("draw", c is not None)
                    p_f, q_f = (torch.softmax(PS.filter_top_k_top_p(
                        ref[P].float()[None] / temp, torch.tensor([top_k]),
                        torch.tensor([top_p]))[0].double(), 0) for ref in (ref_t, ref_d))
                    out["mass"].append(float((p_f - q_f).clamp_min(0).sum()))
            if why:
                return fail(P, why)
        j = P
    if j < n_toks - 1:
        return fail(j, f"the ticks end at {j}, the stream at {n_toks - 1}")
    return out


def hold_spec_streams(engine, target: str, draft: str, streams: list[dict], ticks: dict,
                      rows: int, draft_rows: int, paged: tuple[int, int], err: float,
                      mismatch: bool = False) -> dict:
    """Sampled speculative streams held by :func:`spec_replay` on their
    recorded ticks (``ticks``, :class:`SpecTicks`' by prompt): the
    target's teacher-forced logits with the lane's error ``err`` (the
    verify's, measured on the lane's greedy streams), the draft's with its
    own (measured here at its ``draft_rows`` decode rows and chunked
    prefill).  Fails where a decided draw or verdict disagrees, when an
    error passes ``ERR_LIMIT`` or the decided share of the decisions falls
    under ``SPEC_DECIDED_MIN``.  ``mismatch``: every proposal was shifted by the
    ``spec_mismatch`` fault."""
    refs_t, _ = stream_refs(engine, target, streams, rows, paged, err)
    refs_d, err_d = stream_refs(engine, draft, streams, draft_rows, paged)
    eos = engine.model(target).servable.meta["continuous"]["eos_id"]
    total = {"streams": len(streams), "decided": 0, "undecided": 0, "fail": [],
             "err": err, "err_draft": err_d, "mass": [],
             "kinds": {"draft": [0, 0], "verdict": [0, 0], "draw": [0, 0]}}
    for s, (toks, ref_t), (_, ref_d) in zip(streams, refs_t, refs_d):
        rec = ticks.get(tuple(s["ids"]))
        check(rec, f"{s.get('tag')}: no speculative tick recorded")
        got = spec_replay(ref_t, ref_d, toks, rec, s["knobs"], err, err_d,
                          eos if mismatch else None)
        if got["fail"]:
            total["fail"].append((s.get("tag", "?"), *got["fail"]))
        for k in ("decided", "undecided"):
            total[k] += got[k]
        for k, (a, b) in got["kinds"].items():
            total["kinds"][k][0] += a
            total["kinds"][k][1] += b
        total["mass"] += got["mass"]
    total["decided_share"] = total["decided"] / max(total["decided"] + total["undecided"], 1)
    mass = total["mass"]
    log(f"{target}: {total['streams']} sampled speculative streams replayed on their recorded "
        f"ticks (draft {draft}{', every proposal shifted' if mismatch else ''}): "
        f"{total['decided']} decisions decided, {total['undecided']} outside the margin rule "
        f"(decided, undecided: {total['kinds']}), a decided share of "
        f"{total['decided_share']:.3f} (at least {SPEC_DECIDED_MIN}); {len(mass)} residual draws, "
        f"their mass sum(max(p - q, 0)) mean {float(np.mean(mass)) if mass else 0.0:.4f}, "
        f"median {float(np.median(mass)) if mass else 0.0:.4f}; logit errors {err:.4g} "
        f"(target) and {err_d:.4g} (draft, at most {ERR_LIMIT})")
    check(not total["fail"], f"{target}: speculative streams the replay contradicts: "
                             f"{total['fail'][:8]}")
    check(err_d <= ERR_LIMIT, f"{draft}: the draft's logit error {err_d:.4g} exceeds {ERR_LIMIT}")
    check(total["decided_share"] >= SPEC_DECIDED_MIN,
          f"{target}: the replay decides {total['decided_share']:.3f} of the decisions, "
          f"under {SPEC_DECIDED_MIN}")
    return total


def lane_streams(bodies: list, results: list, max_new: int, tag: str = "") -> list[dict]:
    """The finished streams of a burst, for :func:`hold_streams`: a stream
    shorter than its budget (the request's, capped at the lane's
    ``max_new``) ended on EOS."""
    out = []
    for i, (b, r) in enumerate(zip(bodies, results)):
        if r["status"] != 200:
            continue
        toks = r["tokens"] if "tokens" in r else r["body"]["predictions"]["tokens"]
        budget = min(b["max_new_tokens"], max_new)
        check(len(toks) <= budget, f"stream {i}: {len(toks)} tokens over its budget {budget}")
        out.append({"tag": f"{tag}{i}", "ids": b["input_ids"], "tokens": toks,
                    "ended": len(toks) < budget,
                    "knobs": {k: b[k] for k in ("temperature", "top_k", "top_p", "seed")
                              if k in b}})
    return out


def check_sse(results: list[dict], vocab: int) -> None:
    for i, r in enumerate(results):
        if "times" not in r:
            continue
        check(r["headers"].get("Content-Type") == "text/event-stream"
              and r["headers"].get("Cache-Control") == "no-cache"
              and r["headers"].get("Transfer-Encoding") == "chunked"
              and r["headers"].get("X-Stream-Id"), f"stream {i}: headers {r['headers']}")
        final = r["final"]
        check(final is not None and final.get("done") is True and final["tokens"] == r["tokens"],
              f"stream {i}: the final event {final} does not close the streamed tokens")
        check(all(isinstance(t, int) and 0 <= t < vocab for t in r["tokens"]),
              f"stream {i}: tokens {r['tokens'][:8]}")


def phase_generate_path(cfg, device: str = "cuda", streams: int = GEN_STREAMS,
                        vocab: int = 50257, wavs=None) -> dict:
    """Build the four lanes, serve, and drive them over HTTP: a burst of
    ``streams`` SSE streams and one ``stream: false`` request on each GPT-2
    lane, a shared-prefix prompt cold then warm on the paged lane, a burst
    on the tight lane that must evict and shed 429, and Whisper SSE streams
    of WAVs; then the GETs.  The kernel counts are read just after the load."""
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    t0 = time.perf_counter()
    engine = build_engine(cfg, device)
    log(f"generate engines ready in {time.perf_counter() - t0:.3f} s on {engine.device}: "
        f"build {engine.build_seconds}")
    max_new = cfg.models[0].extra["max_new_tokens"]
    bodies = gen_bodies(streams, vocab=vocab, max_new=max_new)
    out = {"engine": engine, "bodies": bodies}
    with BackgroundServer(cfg, engine) as srv:
        # Each lane's cold start: its pool and every graph it can run,
        # captured ahead of the load (the server captures at first use).
        scheds = srv.server.schedulers
        out["lane_cold_s"] = {}
        for name, sched in scheds.items():
            t0 = time.perf_counter()
            engine.runner.run_fn_sync(sched.warm)
            out["lane_cold_s"][name] = time.perf_counter() - t0
        log(f"lanes warmed: seconds per lane "
            f"{ {k: round(v, 3) for k, v in out['lane_cold_s'].items()} }; graphs "
            f"{ {n: engine.model(n).graphs for n in scheds} }")
        before = {n: s.kernels.graphs.expected_launches() for n, s in scheds.items()}
        reset_counts()
        for name in ("gpt2", "gpt2_paged"):
            # The same burst 1 + GEN_BURSTS times: the first wakes the
            # server's threads and sockets, the rest are timed, and the
            # first of those is held.
            bursts = []
            for i in range(1 + GEN_BURSTS):
                res, wall = gen_burst(srv.port, name,
                                      bodies + [{**bodies[0], "stream": False}])
                check(all(r["status"] == 200 for r in res),
                      f"{name} burst {i}: statuses {[r['status'] for r in res]}")
                check_sse(res[:-1], vocab)
                check(res[-1]["body"]["model"] == name and res[-1]["headers"].get("X-Stream-Id"),
                      f"{name}: stream:false answered {res[-1]}")
                if i:
                    bursts.append((res, wall))
            res, wall = bursts[0]
            out[name] = {"results": res, "wall": wall,
                         "stats": [stream_stats(r[:-1], w) for r, w in bursts]}
        # Warm against cold on the paged lane: a 104-token prompt twice, then
        # one that shares its first 96 tokens (6 pages of 16).
        rng = np.random.default_rng(5)
        shared = rng.integers(0, vocab - 1, 96).tolist()
        pbodies = [{"input_ids": shared + rng.integers(0, vocab - 1, 8).tolist(),
                    "max_new_tokens": 32}]
        pbodies += [dict(pbodies[0]), {"input_ids": shared + rng.integers(0, vocab - 1, 8)
                                       .tolist(), "max_new_tokens": 32}]
        out["prefix"] = [sse(srv.port, "gpt2_paged", b) for b in pbodies]
        out["prefix_bodies"] = pbodies
        # The tight lane (11 pages of 16 at full width): two 72-token prompts,
        # 5 pages each at admission, the second admitted while the first
        # holds at most 6; each grows to 8, so one must be evicted and
        # re-admitted.  Then one 120-token prompt decoding while a burst of
        # four more arrives (the first waits, the rest shed 429 with
        # Retry-After).
        check(scheds["gpt2_tight"].num_blocks - 1 >= 11 and max_new >= 48,
              "the tight lane's pool is too small to admit two 72-token prompts and too large "
              "to hold both")
        tbodies = [{"input_ids": rng.integers(0, vocab - 1, 72).tolist(),
                    "max_new_tokens": max_new} for _ in range(2)]
        with ThreadPoolExecutor(2) as ex:
            first = ex.submit(sse, srv.port, "gpt2_tight", tbodies[0])
            while not scheds["gpt2_tight"].active:  # A admitted: B follows at once
                time.sleep(0.002)
            tres = [first, ex.submit(sse, srv.port, "gpt2_tight", tbodies[1])]
            tres = [f.result() for f in tres]
        long_ = {"input_ids": rng.integers(0, vocab - 1, 120).tolist(), "max_new_tokens": max_new}
        burst = [{"input_ids": rng.integers(0, vocab - 1, 120).tolist(), "max_new_tokens": 8}
                 for _ in range(4)]
        with ThreadPoolExecutor(1) as ex:
            first = ex.submit(sse, srv.port, "gpt2_tight", long_)
            while not scheds["gpt2_tight"].active:
                time.sleep(0.005)
            shed, _ = gen_burst(srv.port, "gpt2_tight", burst)
            first = first.result()
        out["tight"] = {"evict": tres, "evict_bodies": tbodies, "long": first, "long_body": long_,
                        "burst": shed, "burst_bodies": burst,
                        "snapshot": scheds["gpt2_tight"].gen_snapshot()}
        # Whisper: WAVs as SSE streams, all at once.
        wavs = wavs or whisper_wavs(GEN_WHISPER["streams"], seed=40)
        wres, wwall = gen_burst(srv.port, "whisper_tiny", wavs)
        out["whisper"] = {"results": wres, "wall": wwall, "wavs": wavs}
        out["counts"] = read_counts()  # just after the load
        out["expected"] = {}
        for n, s in scheds.items():
            after = s.kernels.graphs.expected_launches()
            for k, v in after.items():
                out["expected"][k] = out["expected"].get(k, 0) + v - before[n].get(k, 0)
        out["per_run"] = {n: dict(s.kernels.graphs.per_run) for n, s in scheds.items()}
        out["kernels"] = {n: s.kernels for n, s in scheds.items()}
        out["snapshots"] = {n: s.gen_snapshot() for n, s in scheds.items()}
        for get in ("/healthz", "/v1/models", "/metrics"):
            status, body = http(srv.port, get)
            check(status == 200, f"{get}: status {status}: {body}")
            out[get] = body
        # The fixed route's answers for the same requests (:predict).
        out["predict"] = {name: [http(srv.port, f"/v1/models/{name}:predict",
                                      {k: v for k, v in b.items() if k != "max_new_tokens"})
                                 for b in bodies] for name in ("gpt2", "gpt2_paged")}
        out["predict"]["whisper_tiny"] = [
            http_raw(srv.port, "/v1/models/whisper_tiny:predict", w, "audio/wav") for w in wavs]
        out["chaos"] = phase_prefix_chaos(srv.port, engine.runner.faults,
                                          scheds["gpt2_paged"], pbodies[0], out["prefix"])
    return out


def phase_prefix_chaos(port: int, faults, sched, body: dict, prefix: list[dict]) -> dict:
    """The prefix cache's chaos modes on the paged lane, its pages warm from
    ``prefix`` (``body`` cold, then warm): ``mode="poison"`` fails every
    lookup, so the request prefills cold and its tokens must equal the cold
    ones; ``mode="cow"`` copies every shared page of the hit, so it stays a
    hit whose tokens must equal the warm ones, with ``cow_copies`` counting
    the copies."""
    name = sched.name
    cold, warm = prefix[0]["tokens"], prefix[1]["tokens"]
    out = {}
    for mode in ("poison", "cow"):
        before = dict(sched.gen_snapshot()["prefix"])
        faults.configure(model=name, fail_every_n=1, kind="prefix", mode=mode)
        try:
            r = sse(port, name, body)
        finally:
            faults.clear(name)
        after = sched.gen_snapshot()["prefix"]
        check(r["status"] == 200, f"prefix chaos {mode}: status {r['status']}")
        cached = r["final"].get("stats", {}).get("prefix_cached_tokens", 0)
        delta = {k: after[k] - before[k] for k in ("hits", "misses", "cow_copies")}
        out[mode] = {"tokens": r["tokens"], "cached": cached, **delta}
    p, c = out["poison"], out["cow"]
    check(p["tokens"] == cold and p["cached"] == 0 and p["misses"] == 1 and p["hits"] == 0,
          f"prefix chaos poison: {p} against cold {cold}")
    check(c["tokens"] == warm and c["cached"] == 96 and c["hits"] == 1 and c["cow_copies"] > 0,
          f"prefix chaos cow: {c} against warm {warm}")
    log(f"{name} prefix chaos: poison prefilled cold ({p['misses']} miss), tokens == cold; cow "
        f"hit 96 cached tokens with {c['cow_copies']} page copies, tokens == warm; warm "
        f"{'==' if warm == cold else '!='} cold")
    return out


def check_generate(run: dict, vocab: int = 50257, whisper_vocab: int = 51865,
                   seg: int = GEN["segment_tokens"], layers: int = 12,
                   whisper_layers: int = 4) -> dict:
    """The load's answers: every stream well formed; each lane's streams,
    the warm and cold prefixes, the evicted streams and the Whisper streams
    held against the fixed route under the margin rule; the tight lane shed
    with Retry-After and the KV fields; the lanes' graphs and each segment's
    int8 launches exact."""
    engine = run["engine"]
    rows = GEN["gen_slots"]
    max_new = engine.model("gpt2").servable.meta["max_new_tokens"]
    paged = (GEN["chunk"], GEN["block_size"])  # the paged lanes' prefill chunk and page
    held = {}
    for name in ("gpt2", "gpt2_paged"):
        res = run[name]["results"]
        for i, st in enumerate(run[name]["stats"]):
            log(f"{name} burst {i}: {st['streams']} SSE streams + 1 stream:false, {st['tokens']} "
                f"tokens in {st['wall_s']:.3f} s ({st['tok_per_s']:.1f} tokens/s); client TTFT "
                f"p50 {st['ttft_p50']:.3f} ms, p99 {st['ttft_p99']:.3f} ms; inter-token p50 "
                f"{st['itl_p50']:.3f} ms, p99 {st['itl_p99']:.3f} ms")
        same = sum(p[1]["predictions"]["tokens"][: len(r["tokens"])] == r["tokens"]
                   for p, r in zip(run["predict"][name], res[:-1]) if p[0] == 200)
        log(f"{name}: {same} of {len(res) - 1} streams token for token the :predict answer cut "
            f"at their budget")
        # The stream:false request (the burst's first body again) is held
        # under the same rule: it shares no admission batch with its twin.
        held[name] = hold_streams(engine, name,
                                  lane_streams(run["bodies"] + run["bodies"][:1], res, max_new),
                                  rows, paged if name == "gpt2_paged" else None)
    # Warm against cold.
    pres, pb = run["prefix"], run["prefix_bodies"]
    check(all(r["status"] == 200 for r in pres), f"prefix statuses {[r['status'] for r in pres]}")
    cached = [r["final"].get("stats", {}).get("prefix_cached_tokens", 0) for r in pres]
    check(cached == [0, 96, 96], f"prefix cached tokens {cached}, want [0, 96, 96]")
    log(f"gpt2_paged prefix: cold TTFT {1e3 * pres[0]['times'][0]:.3f} ms, warm "
        f"{1e3 * pres[1]['times'][0]:.3f} ms (96 cached tokens), shared-prefix other prompt "
        f"{1e3 * pres[2]['times'][0]:.3f} ms; warm tokens {'==' if pres[0]['tokens'] == pres[1]['tokens'] else '!='} "
        f"cold tokens")
    held["prefix"] = hold_streams(engine, "gpt2_paged", lane_streams(pb, pres, max_new, "prefix"),
                                  rows, paged)
    # The tight lane: evictions kept correct, the burst shed with Retry-After.
    t = run["tight"]
    snap = t["snapshot"]
    check(all(r["status"] == 200 for r in t["evict"]) and t["long"]["status"] == 200,
          f"tight lane statuses {[r['status'] for r in t['evict']]}, {t['long']['status']}")
    check(snap["kv"]["evictions"] > 0, f"the tight lane evicted nothing: {snap['kv']}")
    shed = [r for r in t["burst"] if r["status"] == 429]
    check(shed, f"the tight lane's burst shed nothing: {[r['status'] for r in t['burst']]}")
    for r in shed:
        check(int(r["headers"]["Retry-After"]) >= 1 and r["body"]["kv_blocks_needed"] > 0
              and "kv_blocks_free" in r["body"] and r["body"]["estimated_wait_ms"] > 0,
              f"a 429 without Retry-After or the KV fields: {r}")
    served = [r for r in t["burst"] if r["status"] == 200]
    log(f"gpt2_tight: {snap['kv']['evictions']} evictions, {len(shed)} of {len(t['burst'])} "
        f"burst requests shed 429 (Retry-After {[r['headers']['Retry-After'] for r in shed]}, "
        f"estimated_wait_ms {[r['body']['estimated_wait_ms'] for r in shed]}), {len(served)} "
        f"served after the wait")
    tb = t["evict_bodies"] + [t["long_body"]] + [b for b, r in zip(t["burst_bodies"], t["burst"])
                                                  if r["status"] == 200]
    tr = t["evict"] + [t["long"]] + served
    held["tight"] = hold_streams(engine, "gpt2_paged", lane_streams(tb, tr, max_new, "tight"), 2,
                                 paged)
    # Whisper streams against :predict on the same audio.
    w = run["whisper"]
    check(all(r["status"] == 200 for r in w["results"]), "whisper stream statuses")
    check_sse(w["results"], whisper_vocab)
    cm = engine.model("whisper_tiny")
    wstreams = []
    for i, (wav, r, p) in enumerate(zip(w["wavs"], w["results"], run["predict"]["whisper_tiny"])):
        check(p[0] == 200, f"whisper :predict status {p}")
        wstreams.append({"tag": f"w{i}", "mel": cm.servable.preprocess(wav)["mel"],
                         "tokens": r["tokens"],
                         "ended": len(r["tokens"]) < cm.servable.meta["max_new_tokens"],
                         "predict": p[1]["predictions"]["tokens"]})
    same = sum(s["tokens"] == s["predict"] for s in wstreams)
    lat = run["/metrics"]["generation"]["whisper_tiny"]["latency"]
    log(f"whisper_tiny: {len(wstreams)} SSE streams in {w['wall']:.3f} s (client TTFT ms "
        f"{[round(1e3 * r['times'][0], 3) for r in w['results']]}; server-side TTFT from "
        f"admission, cumulative {lat['ttft_ms']['buckets']}), {same} token for token the "
        f":predict answer")
    held["whisper"] = hold_streams(engine, "whisper_tiny", wstreams, GEN_WHISPER["gen_slots"])
    # Launch counts: exact against the lanes' graphs, and a segment's.
    exact_counts(run["counts"], run["expected"], "the :generate load")
    per_seg = {"gpt2": (4 * layers + 1) * seg, "whisper_tiny": (8 * whisper_layers + 1) * seg}
    for name, want in per_seg.items():
        if engine.device.type != "cuda":
            break  # the CPU's wrappers run the plain version and count nothing
        segs = {k: v for k, v in run["per_run"][name].items() if k[0] == "segment"}
        check(segs and all(v.get("int8_matmul") == want for v in segs.values()),
              f"{name}: int8_matmul launches a segment {segs}, want {want}")
        pre = {k: v for k, v in run["per_run"][name].items() if k[0] == "prefill"}
        check(all(v.get("int8_matmul") == want // seg for v in pre.values()),
              f"{name}: int8_matmul launches a prefill {pre}")
    log(f"generate load: int8_matmul launched {run['counts']['int8_matmul']} times, exactly the "
        f"lanes' graph runs ({per_seg['gpt2']} a GPT-2 segment, {per_seg['whisper_tiny']} a "
        f"Whisper segment); lane snapshots "
        f"{ {n: {k: s[k] for k in ('device_rounds', 'segment_rounds', 'tokens_emitted')} for n, s in run['snapshots'].items()} }")
    m = run["/metrics"]
    check(all(f"{n}:generate" in m["models"] for n in ("gpt2", "gpt2_paged", "whisper_tiny")),
          f"/metrics rings {sorted(m['models'])}")
    for n in ("gpt2", "gpt2_paged"):
        lat = m["generation"][n]["latency"]
        log(f"{n} server-side histograms (ms, cumulative): TTFT {lat['ttft_ms']['buckets']}, "
            f"inter-token {lat['itl_ms']['buckets']}")
    check(m["generation"]["gpt2_paged"]["mode"] == "paged" and m["generation"]["gpt2"]["mode"]
          == "slot", "the /metrics generation block")
    check(run["/healthz"]["generation_ok"] is True, f"/healthz {run['/healthz']}")
    return held


def gen_payloads(cm, rng, sizes, knobs) -> list[dict]:
    """Batched admission payloads of the lane: one per entry of ``sizes``
    ((batch, prompt tokens) for GPT-2, (batch, None) for Whisper)."""
    meta = cm.servable.meta["continuous"]
    vocab = cm.servable.meta["config"].vocab_size
    out = []
    for B, plen in sizes:
        parts = []
        for j in range(B):
            k = knobs[j % len(knobs)]
            if plen is None:
                sample = {"mel": rng.standard_normal((80, 3000)).astype(np.float32), **k}
                parts.append(meta["collate_admit"](sample, 1))
            else:
                s = cm.servable.preprocess({"input_ids": rng.integers(0, vocab - 1, plen).tolist(),
                                            **k})
                parts.append(meta["collate_admit"](s, cm.bucket_for(1, plen)[1]))
        out.append({key: np.concatenate([p[key] for p in parts]) for key in parts[0]})
    return out


def empty_carries(S: int) -> dict:
    return {"tok": np.zeros(S, np.int32), "pos": np.zeros(S, np.int32),
            "step": np.zeros(S, np.int32), "fin": np.ones(S, bool),
            "temp": np.zeros(S, np.float32), "seed": np.zeros(S, np.int32),
            "topk": np.zeros(S, np.int32), "topp": np.ones(S, np.float32)}


def seat(carries: dict, slot: int, first: int, payload: dict, j: int) -> None:
    carries["tok"][slot], carries["pos"][slot] = first, payload["length"][j]
    carries["step"][slot], carries["fin"][slot] = 0, False
    carries["temp"][slot], carries["seed"][slot] = payload["temperature"][j], payload["seed"][j]
    carries["topk"][slot], carries["topp"][slot] = payload["top_k"][j], payload["top_p"][j]


def pool_bits(k, skip_trash: bool = False) -> bytes:
    start = 1 if skip_trash else 0
    return b"".join(t[:, start:].contiguous().view(torch.int16).cpu().numpy().tobytes()
                    for t in (k.cache_k, k.cache_v))


def phase_gen_replay(engine) -> None:
    """Each new graph against the same program run eagerly on a second pool,
    at full width: the slot lanes' (GPT-2 int8, Whisper int8) prefill graphs
    (two batch sizes), insert and segment graphs (greedy and sampled,
    filtered), the paged lane's chunk graphs (two lengths), page copy and
    segment: first tokens, packed emits and carries, and the pools byte for
    byte (the paged pool but its trash page).  Then one GPT-2 stream decoded
    from slot 0 and from the pool's last slot beside other streams: the same
    tokens, byte for byte."""
    from pytorch_zappa_serverless_tpu_torch.engine.genkernels import (PagedKernels, SlotKernels,
                                                                      unpack)

    run = engine.runner.run_fn_sync
    rng = np.random.default_rng(21)
    hot = [{"temperature": 0.0}, {**GEN_SAMPLED, "seed": 3}]
    for name, sizes in (("gpt2", [(2, 60), (1, 12)]), ("whisper_tiny", [(2, None), (1, None)])):
        cm = engine.model(name)
        meta = cm.servable.meta["continuous"]
        S = meta["slots"]
        payloads = gen_payloads(cm, rng, sizes, hot)
        outs = []
        for k in (SlotKernels(cm), SlotKernels(cm, graphed=False)):
            run(k.ensure)
            carries, seats, firsts, segs = empty_carries(S), iter([S - 1, 0, 2]), [], []
            for p in payloads:
                first = run(k.prefill, p)
                firsts.append(first)
                for j in range(len(p["length"])):
                    slot = next(seats)
                    run(k.insert_from, j, slot)
                    seat(carries, slot, first[j], p, j)
            for rnd in range(3):
                if rnd == 2:  # the sampled row retires: a greedy-only segment
                    carries["fin"][0] = True
                    carries["temp"][0] = 0.0
                out = run(k.segment, carries)
                segs.append(out)
                _, carries["tok"], carries["pos"], carries["step"], carries["fin"] = \
                    unpack(out, meta["segment_tokens"])
            outs.append((firsts, segs, pool_bits(k), k))
        (f0, s0, b0, kg), (f1, s1, b1, _) = outs
        check(all(a.tobytes() == b.tobytes() for a, b in zip(f0, f1)),
              f"{name}: replayed prefill first tokens differ from eager")
        check(all(a.tobytes() == b.tobytes() for a, b in zip(s0, s1)),
              f"{name}: replayed segments differ from eager")
        check(b0 == b1, f"{name}: the pool after the replayed programs differs from eager")
        log(f"{name} slot lane replay vs eager: {kg.graphs.labels}: first tokens, 3 segments "
            f"and the pool ({len(b0) / 2**20:.1f} MiB) bitwise equal; launches a run "
            f"{ {kg.graphs.label(k): v.get('int8_matmul', 0) for k, v in kg.graphs.per_run.items()} }")
    # The paged lane.
    cm = engine.model("gpt2_paged")
    meta = cm.servable.meta["continuous"]
    S, BS = meta["slots"], GEN["block_size"]
    MB = -(-meta["total"] // BS)
    vocab = cm.servable.meta["config"].vocab_size
    ids = rng.integers(0, vocab - 1, 100).astype(np.int32)
    short = rng.integers(0, vocab - 1, 5).astype(np.int32)
    table = np.zeros((1, MB), np.int32)
    table[0] = np.arange(1, MB + 1)
    table_s = np.zeros((2, MB), np.int32)
    table_s[0] = np.arange(MB + 1, 2 * MB + 1)

    def chunk(toks, start, length, tab):
        G = toks.shape[0]
        return (toks.astype(np.int32), np.asarray(start, np.int32), np.asarray(length, np.int32),
                np.asarray([0.0, 0.9][:G], np.float32), np.asarray([0, 4][:G], np.int32),
                np.asarray([0, 40][:G], np.int32), np.asarray([1.0, 0.95][:G], np.float32), tab,
                np.zeros(G, np.int32))

    outs = []
    for k in (PagedKernels(cm, BS, 2 * MB + 2, 4), PagedKernels(cm, BS, 2 * MB + 2, 4,
                                                                  graphed=False)):
        run(k.ensure)
        f = [run(k.prefill_chunk, chunk(ids[None, :64], [0], [100], table)),
             run(k.prefill_chunk, chunk(np.pad(ids[None, 64:], ((0, 0), (0, 28))), [64], [100],
                                        table)),
             run(k.prefill_chunk, chunk(np.stack([np.pad(short, (0, 3)), np.zeros(8, np.int32)]),
                                        [0, 0], [5, 1], table_s))]
        run(k.copy_page, 1, 2 * MB + 1)
        seg_table = np.zeros((S, MB), np.int32)
        seg_table[0], seg_table[S - 1] = table[0], table_s[0]
        c = empty_carries(S)
        c["tok"][0], c["pos"][0], c["fin"][0] = f[1][0], 100, False
        c["tok"][S - 1], c["pos"][S - 1], c["fin"][S - 1] = f[2][0], 5, False
        c["temp"][S - 1], c["seed"][S - 1], c["topk"][S - 1], c["topp"][S - 1] = 0.9, 4, 40, 0.95
        segs = []
        for _ in range(2):
            out = run(k.segment, seg_table, c)
            segs.append(out)
            _, c["tok"], c["pos"], c["step"], c["fin"] = unpack(out, meta["segment_tokens"])
        outs.append((f, segs, pool_bits(k, skip_trash=True), k))
    (f0, s0, b0, kg), (f1, s1, b1, _) = outs
    # The third chunk's pad row (an all-trash table) reads the trash page,
    # whose colliding writes land in either order: its first token is not
    # compared.
    f0[2], f1[2] = f0[2][:1], f1[2][:1]
    check(all(a.tobytes() == b.tobytes() for a, b in zip(f0 + s0, f1 + s1)),
          "gpt2_paged: replayed chunks or segments differ from eager")
    check(b0 == b1, "gpt2_paged: the pages after the replayed programs differ from eager")
    log(f"gpt2_paged lane replay vs eager: {kg.graphs.labels}: 3 chunks, a page copy, 2 "
        f"segments and every page but the trash page ({len(b0) / 2**20:.1f} MiB) bitwise equal")
    # One stream in slot 0, then in the last slot, beside other streams.
    cm = engine.model("gpt2")
    meta = cm.servable.meta["continuous"]
    S = meta["slots"]
    mine, other1, other2 = gen_payloads(cm, rng, [(1, 30), (1, 50), (1, 9)],
                                        [{**GEN_SAMPLED, "seed": 8}])
    k = SlotKernels(cm)
    streams = []
    for slot, other_slot, other in ((0, 1, other1), (S - 1, 3, other2)):
        run(k.reset)
        run(k.ensure)
        c = empty_carries(S)
        for s_, p in ((other_slot, other), (slot, mine)):
            first = run(k.prefill, p)
            run(k.insert_from, 0, s_)
            seat(c, s_, first[0], p, 0)
        toks = []
        for _ in range(3):
            out = run(k.segment, c)
            emits, c["tok"], c["pos"], c["step"], c["fin"] = unpack(out, meta["segment_tokens"])
            toks += emits[slot].tolist()
        streams.append(toks)
    check(streams[0] == streams[1], f"a stream in slot 0 and slot {S - 1}: {streams}")
    log(f"gpt2: one sampled stream decoded from slot 0 and from slot {S - 1} beside other "
        f"streams: the same {len(streams[0])} tokens, byte for byte")


def phase_gen_timing(engine, scheds: dict | None = None) -> dict:
    """Device ms of one greedy segment of each lane, replayed (its graph)
    and eager (its functions on the graph's static inputs), by
    ``device_ms``; on the live lanes' pools, after the load (a segment over
    finished rows writes only their own frozen positions)."""
    from pytorch_zappa_serverless_tpu_torch.engine.genkernels import LaneGraphs, PagedKernels
    from pytorch_zappa_serverless_tpu_torch.ops.sampling import Gates

    greedy = Gates(False, False, False)
    rows = {}
    for name, kern in (scheds or {}).items():
        g = kern.graphs._graphs.get(("segment", greedy))
        if g is None:
            continue
        meta = engine.model(name).servable.meta["continuous"]
        tree, i = kern.graphs.tree, g.inputs
        carries = [i[k] for k in ("tok", "pos", "step", "fin", "temp", "seed", "topk", "topp")]
        if isinstance(kern, PagedKernels):
            def eager(k=kern, c=carries, t=i["table"]):
                with torch.inference_mode():
                    k.fns["segment"](tree, k.cache_k, k.cache_v, t, *c, gates=greedy)
        else:
            def eager(k=kern, c=carries, m=meta):
                with torch.inference_mode():
                    m["segment"](tree, k.cache_k, k.cache_v, *c, gates=greedy)

        def timings(g=g, eager=eager):
            return device_ms(g.captured.replay), device_ms(eager, reps=3)

        replay_ms, eager_ms = engine.runner.run_fn_sync(timings)
        seg = meta["segment_tokens"]
        rows[name] = {"replay_ms": replay_ms, "eager_ms": eager_ms,
                      "position_ms": replay_ms / seg}
        log(f"{name}: device ms a greedy segment ({seg} positions, {meta['slots']} rows) "
            f"replayed {replay_ms:.4f} ({replay_ms / seg:.4f} a position), eager {eager_ms:.4f}; "
            f"{LaneGraphs.label(('segment', greedy))}")
    return rows


def phase_gen_profile(engine, kern, name: str) -> None:
    """``torch.profiler`` over one greedy segment of a lane, eager against
    replayed, per position."""
    from pytorch_zappa_serverless_tpu_torch.ops.sampling import Gates
    from pytorch_zappa_serverless_tpu_torch.tools import bench_fused_decode as BF

    greedy = Gates(False, False, False)
    g = kern.graphs._graphs[("segment", greedy)]
    meta = engine.model(name).servable.meta["continuous"]
    c = [g.inputs[k] for k in ("tok", "pos", "step", "fin", "temp", "seed", "topk", "topp")]

    def eager():
        with torch.inference_mode():
            meta["segment"](kern.graphs.tree, kern.cache_k, kern.cache_v, *c, gates=greedy)

    run = engine.runner.run_fn_sync
    log_profiles(f"{name} segment", "position", run(BF.profile, eager, 1),
                 run(BF.profile, g.captured.replay, 1), per=meta["segment_tokens"])


def run_generate(profile: bool) -> dict:
    """The :generate phase: the load, its checks, replay against eager at full
    width, and the segment timings; returns int8_matmul's launches on the
    load and the timings."""
    fresh_memory()
    t0 = time.perf_counter()
    run = phase_generate_path(generate_config())
    engine = run["engine"]
    try:
        log_memory("generate", engine)
        held = check_generate(run)
        log(f"generate load and its checks in {time.perf_counter() - t0:.3f} s")
        phase_gen_replay(engine)
        timing = phase_gen_timing(engine, run["kernels"])
        if profile:
            phase_gen_profile(engine, run["kernels"]["gpt2"], "gpt2")
    finally:
        engine.shutdown()
    return {"launches": run["counts"]["int8_matmul"], "timing": timing, "held": held,
            "stats": {n: run[n]["stats"] for n in ("gpt2", "gpt2_paged")},
            "lane_cold_s": run["lane_cold_s"], "prefix": run["prefix"]}


# -- phase 14: the failure path ----------------------------------------------

# A probe waits this long for the dispatch thread (above any capture the
# phase makes; the rebuild's quiesce waits as long).
FAIL_PROBE_S = 5.0
# The resilience settings the phase serves under, and the :generate lane of
# its GPT-2 (the slot pool, as phase 13's int8 lane).
FAIL = {"retry_max_attempts": 3, "breaker_threshold": 0.5, "breaker_min_samples": 4,
        "watchdog_interval_s": 0.5, "dispatch_probe_timeout_s": FAIL_PROBE_S}
FAIL_GEN = {"gen_slots": 8, "segment_tokens": 8, "max_new_tokens": 32}
# Check 4: how long the last /healthz verdict is kept (DeviceRunner.probe's
# cache), and how long a slow dispatch wedges the lane: past the timeout of
# the one probe that eight /healthz share.
FAIL_WEDGE_MS = 8000
FAIL_PROBE_CACHE_S = 5.0
# Check 2: the latency that holds the lane, the deadline of the requests
# queued behind it, and how many there are.
FAIL_SLOW_MS = 200
FAIL_DEADLINE_MS = 50
FAIL_SHED = 6
# How long a recovery (poison → /healthz 200) may take before the phase
# fails, and how many poison → recovery cycles check 4 runs.
FAIL_RECOVERY_S = 600
FAIL_POISON_CYCLES = 1


def failure_config(bert_arch: dict | None = None, gpt2_arch: dict | None = None, **gpt2_extra):
    """BERT-base int8 at (1, 8) x 128 and GPT-2 small int8 at (1,) x 64 with a
    slot-pool :generate lane, under :data:`FAIL`'s resilience settings."""
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig

    return ServeConfig(**FAIL, models=[
        ModelConfig(name="bert_base", dtype="bfloat16", seq_buckets=(BERT["seq"],),
                    batch_buckets=BERT["batch_buckets"],
                    extra={"params_dtype": "int8", **({"arch": bert_arch} if bert_arch else {})}),
        ModelConfig(name="gpt2", dtype="bfloat16", seq_buckets=(GPT2["seq"],), batch_buckets=(1,),
                    extra={"params_dtype": "int8", **FAIL_GEN,
                           **({"arch": gpt2_arch} if gpt2_arch else {}), **gpt2_extra})])


def http_h(port: int, path: str, body=None, headers: dict | None = None, timeout: float = 120.0):
    """(status, JSON or text body, headers) of one request."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw, status, hdrs = r.read(), r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw, status, hdrs = e.read(), e.code, dict(e.headers)
    if hdrs.get("Content-Type", "").startswith("application/json"):
        return status, json.loads(raw), hdrs
    return status, raw.decode(), hdrs


def wait_until(pred, timeout: float, what: str, every: float = 0.05) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        check(time.monotonic() < deadline, f"timed out after {timeout} s waiting for {what}")
        time.sleep(every)


def device_census() -> dict:
    """What the process keeps alive: CompiledModel objects, captured CUDA
    graphs, and the bytes of the distinct CUDA storages Python can reach."""
    models = graphs = 0
    storages = {}
    for o in gc.get_objects():
        if type(o).__name__ == "CompiledModel":
            models += 1
        elif torch.cuda.is_available() and isinstance(o, torch.cuda.CUDAGraph):
            graphs += 1
        elif torch.is_tensor(o) and o.is_cuda:
            st = o.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
    return {"models": models, "graphs": graphs, "tensor_mib": round(sum(storages.values()) / 2**20, 1)}


def check_metrics_tool():
    """``tools/check_metrics.py`` (stdlib only), loaded by path."""
    spec = importlib.util.spec_from_file_location("check_metrics", "tools/check_metrics.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_failure_path(cfg, device: str = "cuda", per_forward: int = 72, bert_vocab: int = 30522,
                       gpt2_vocab: int = 50257, card: str = "") -> dict:
    """Serve BERT and GPT-2 over HTTP and drive the failure path: transient
    retries, deadline shedding, the breaker's isolation and the watchdog's
    recovery from it, a poisoned runner's shared probe and recovery (freed
    memory, byte-equal answers), drain with a stream in flight, and the
    Prometheus exposition against the manifest.  ``per_forward`` is
    ``int8_matmul``'s launches a BERT forward (0 on the CPU, where the
    wrappers compute their plain versions and count nothing)."""
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    cuda = torch.device(device).type == "cuda"
    rng = np.random.default_rng(14)
    bodies = [{"input_ids": rng.integers(1, bert_vocab - 1, n).tolist()}
              for n in (5, 20, 40, 64, 90, 120)]
    gpt2_body = {"input_ids": rng.integers(0, gpt2_vocab - 1, 24).tolist()}
    gen_body = {"input_ids": rng.integers(0, gpt2_vocab - 1, 16).tolist(), "max_new_tokens": 24}
    bert, gpt2 = "/v1/models/bert_base:predict", "/v1/models/gpt2:predict"
    out = {}
    t0 = time.perf_counter()
    # The server builds its engine and owns it, as `serve` runs it: a
    # recovery frees the engine it replaces.
    with BackgroundServer(cfg, device=device) as srv:
        server, port = srv.server, srv.port
        log(f"{card}: failure-path engines ready in {time.perf_counter() - t0:.3f} s on "
            f"{server.engine.device}: build {server.engine.build_seconds}")

        def answers() -> list:
            """BERT's bodies one at a time, GPT-2 :predict and a :generate
            stream: what must come back byte-equal after every fault."""
            got = []
            for path, body in [(bert, b) for b in bodies] + [(gpt2, gpt2_body)]:
                status, o, _ = http_h(port, path, body)
                check(status == 200, f"{path}: status {status}: {o}")
                got.append(json.dumps(o["predictions"], sort_keys=True))
            r = sse(port, "gpt2", gen_body)
            check(r["status"] == 200 and r["final"] and r["final"]["done"],
                  f"gpt2 :generate answered {r}")
            return got + [r["tokens"]]

        def healthy() -> bool:
            return http_h(port, "/healthz")[0] == 200

        free = answers()
        mr = server.resilience.model("bert_base")
        # What one engine holds with every graph captured: each recovery must
        # come back to it, within one engine's weights.
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        weights = sum(cm.param_nbytes() for cm in server.engine.models.values())
        mem0 = torch.cuda.memory_allocated() if cuda else 0
        census0 = device_census()
        graphs0 = {n: cm.graphs for n, cm in server.engine.models.items()}

        def after_recovery(what: str, old) -> dict:
            """Byte-equal answers from the new engine, every graph captured
            again, and the old engine (a weak reference) gone with its memory."""
            check(answers() == free, f"{what}: the answers after recovery differ from the "
                                     "fault-free bytes")
            graphs = {n: cm.graphs for n, cm in server.engine.models.items()}
            check(graphs == graphs0, f"{what}: graphs {graphs} after recovery, {graphs0} before")
            gc.collect()
            check(old() is None, f"{what}: the replaced engine is still reachable")
            row = {"mem": torch.cuda.memory_allocated() if cuda else 0,
                   "census": device_census(),
                   "graphs": {n: len(g) for n, g in graphs.items()}}
            check(row["mem"] - mem0 <= weights,
                  f"{what}: allocated {row['mem']} bytes after recovery against {mem0} before, "
                  f"more than one engine's weights ({weights}): the old engine was not freed")
            check(row["census"]["models"] == census0["models"],
                  f"{what}: {row['census']['models']} CompiledModel objects alive after the "
                  f"recovery, {census0['models']} before: the old engine was not freed")
            return row

        # 1. Transient: every second dispatch fails, three times; retried.
        runner = server.engine.runner
        stats = runner.stats["bert_base"]
        retries0, batches0 = mr.stats.retries, stats.batches
        runner.faults.configure(model="bert_base", fail_every_n=2, count=3, kind="transient")
        reset_counts()
        got = []
        for b in bodies[:5]:
            status, o, _ = http_h(port, bert, b)
            check(status == 200, f"transient: status {status}: {o}")
            got.append(json.dumps(o["predictions"], sort_keys=True))
        counts = read_counts()
        injected = runner.faults.snapshot()["injected"]["dispatch"]
        runner.faults.clear()
        ran = stats.batches - batches0
        check(got == free[:5], "transient: the retried answers differ from the fault-free bytes")
        check(mr.stats.retries - retries0 == 3 and injected == 3 and ran == 5,
              f"transient: retries +{mr.stats.retries - retries0}, injected {injected}, "
              f"dispatches ran {ran}")
        exact_counts(counts, {"int8_matmul": per_forward * ran}, "failure path, transient")
        out["launches"] = counts["int8_matmul"]
        log(f"{card}: check 1 transient: 5 BERT answers 200 and byte-equal to the fault-free "
            f"ones; dispatch_retries +3; {ran} dispatches ran; int8_matmul launches "
            f"{counts['int8_matmul']} = {per_forward} x {ran}")

        # 2. Deadline: a slow dispatch holds the lane; what queues behind it
        # with a short deadline answers 504 and never reaches the device.
        batches0, dl0 = stats.batches, mr.stats.deadline_exceeded
        buckets0 = {b: v["batches"] for b, v in stats.by_bucket.items()}
        slept0 = runner.faults.snapshot()["injected"]["latency_ms"]
        runner.faults.configure(model="bert_base", latency_ms=FAIL_SLOW_MS)
        reset_counts()
        with ThreadPoolExecutor(FAIL_SHED + 1) as ex:
            slow = ex.submit(http_h, port, bert, bodies[0])
            # The dispatch thread is in the slow dispatch's sleep once the
            # injector has booked its latency.
            wait_until(lambda: runner.faults.snapshot()["injected"]["latency_ms"] > slept0, 10,
                       "the slow dispatch", every=0.001)
            shed = [ex.submit(http_h, port, bert, b, {"X-Deadline-Ms": str(FAIL_DEADLINE_MS)})
                    for b in bodies[:FAIL_SHED]]
            shed = [f.result() for f in shed]
            slow = slow.result()
        time.sleep(0.2)  # the batcher pops the expired requests and drops them
        counts = read_counts()
        runner.faults.clear()
        check(slow[0] == 200 and json.dumps(slow[1]["predictions"], sort_keys=True) == free[0],
              f"deadline: the slow request answered {slow[0]}")
        stages = [o.get("stage") for _, o, _ in shed]
        check(all(st == 504 for st, _, _ in shed) and set(stages) <= {"queue", "await"},
              f"deadline: statuses {[st for st, _, _ in shed]}, stages {stages}")
        ran = {b: v["batches"] - buckets0.get(b, 0) for b, v in stats.by_bucket.items()}
        check(mr.stats.deadline_exceeded - dl0 == FAIL_SHED and stats.batches - batches0 == 1,
              f"deadline: deadline_exceeded +{mr.stats.deadline_exceeded - dl0}, batches "
              f"+{stats.batches - batches0} by bucket {ran}, stages {stages}, answers "
              f"{[o for _, o, _ in shed]}")
        exact_counts(counts, {"int8_matmul": per_forward}, "failure path, deadline")
        out["launches"] += counts["int8_matmul"]
        log(f"{card}: check 2 deadline: {FAIL_SHED} requests with X-Deadline-Ms "
            f"{FAIL_DEADLINE_MS} behind a {FAIL_SLOW_MS} ms dispatch answered 504 (stages "
            f"{sorted(set(stages))}); deadline_exceeded +{FAIL_SHED}; one batch ran, "
            f"int8_matmul launches {counts['int8_matmul']}")
        del runner, stats

        # 3. Breaker: a fatal rule on BERT at every dispatch.  The watchdog is
        # paused so that the breaker's isolation is seen alone, then resumed
        # to recover from the open breaker's fatal cause.
        srv.call(server.watchdog.stop)
        server.engine.runner.faults.configure(model="bert_base", fail_every_n=1, kind="fatal")
        fails = 0
        for _ in range(40):
            status, o, hdrs = http_h(port, bert, bodies[0])
            if status != 500:
                break
            fails += 1
        check(status == 503 and o.get("breaker") == "open" and "Retry-After" in hdrs,
              f"breaker: after {fails} failures status {status}: {o}")
        t1 = time.perf_counter()
        status, o, hdrs = http_h(port, bert, bodies[1])
        fast_ms = (time.perf_counter() - t1) * 1e3
        check(status == 503 and "Retry-After" in hdrs, f"breaker: fast-fail answered {status}")
        status, o, _ = http_h(port, gpt2, gpt2_body)
        check(status == 200 and json.dumps(o["predictions"], sort_keys=True) == free[-2],
              f"breaker: GPT-2 :predict answered {status} or other bytes while BERT's "
              "breaker was open")
        r = sse(port, "gpt2", gen_body)
        check(r["status"] == 200 and r["tokens"] == free[-1],
              "breaker: GPT-2 :generate differs while BERT's breaker was open")
        server.engine.runner.faults.clear()
        original, rec0 = weakref.ref(server.engine), server.watchdog.recoveries_total
        srv.call(server.watchdog.start)
        t1 = time.perf_counter()
        wait_until(lambda: server.watchdog.recoveries_total > rec0 and healthy(),
                   FAIL_RECOVERY_S, "the recovery from the breaker's fatal cause")
        breaker_recovery_s = time.perf_counter() - t1
        check(server.engine is not original() and mr.breaker.state == "closed",
              "breaker: the watchdog did not rebuild and reset the breaker")
        breaker_row = after_recovery("breaker", original)
        log(f"{card}: check 3 breaker: open after {fails} fatal 500s; BERT fast-fails 503 with "
            f"Retry-After in {fast_ms:.3f} ms; GPT-2 :predict and :generate byte-equal "
            f"meanwhile; the watchdog rebuilt on the fatal cause in {breaker_recovery_s:.3f} s "
            f"(rebuild {server.watchdog.last_rebuild_s} s); the answers are byte-equal, graphs "
            f"re-captured {breaker_row['graphs']}, memory_allocated {mem0 / 2**20:.1f} MiB "
            f"before, {breaker_row['mem'] / 2**20:.1f} MiB after (one engine's weights "
            f"{weights / 2**20:.1f} MiB); live objects before {census0}, after "
            f"{breaker_row['census']}")

        # 4. A wedge, then a poison; twice, to tell a one-time cost from
        # memory each recovery leaves.  The watchdog is paused while a slow
        # dispatch wedges the lane: eight concurrent /healthz share one probe
        # and its timeout.  Then the runner is poisoned (dead with no
        # dispatch) and the resumed watchdog rebuilds.
        cycles = []
        for cycle in range(FAIL_POISON_CYCLES):
            runner = server.engine.runner
            srv.call(server.watchdog.stop)
            time.sleep(FAIL_PROBE_CACHE_S)  # the last /healthz verdict lapses
            slept0 = runner.faults.snapshot()["injected"]["latency_ms"]
            runner.faults.configure(model="bert_base", latency_ms=FAIL_WEDGE_MS)
            probes0 = runner.probe_dispatches
            barrier = threading.Barrier(8)

            def healthz(_):
                barrier.wait()
                return http_h(port, "/healthz")[0]

            with ThreadPoolExecutor(9) as ex:
                slow = ex.submit(http_h, port, bert, bodies[0])
                wait_until(lambda: runner.faults.snapshot()["injected"]["latency_ms"] > slept0,
                           10, "the wedging dispatch", every=0.001)
                health = list(ex.map(healthz, range(8)))
                slow = slow.result()
            runner.faults.clear()
            probes = runner.probe_dispatches - probes0
            check(health == [503] * 8 and probes == 1,
                  f"wedge: /healthz answered {health} through {probes} probes")
            check(slow[0] == 200 and json.dumps(slow[1]["predictions"], sort_keys=True) == free[0],
                  f"wedge: the slow request answered {slow[0]}")
            old, rec0 = weakref.ref(server.engine), server.watchdog.recoveries_total
            t1 = time.perf_counter()
            runner.poison(RuntimeError("injected fatal device fault"))
            srv.call(server.watchdog.start)
            wait_until(lambda: server.watchdog.recoveries_total > rec0 and healthy(),
                       FAIL_RECOVERY_S, "the recovery from the poison")
            recovery_s = time.perf_counter() - t1
            check(server.engine.runner is not runner, "poison: the runner was not replaced")
            del runner
            new = server.engine
            timing = {"recovery_s": recovery_s, "rebuild_s": server.watchdog.last_rebuild_s,
                      "cold_s": new.cold_start_seconds, "capture_s": new.clock.total_seconds}
            del new
            row = {**timing, **after_recovery("poison", old)}
            cycles.append(row)
            log(f"{card}: check 4 wedge and poison, cycle {cycle + 1}: 8 concurrent /healthz "
                f"503 through 1 shared probe behind a {FAIL_WEDGE_MS} ms dispatch (timeout "
                f"{FAIL_PROBE_S} s); recovery (poison -> /healthz 200) {recovery_s:.3f} s; "
                f"rebuild {row['rebuild_s']} s, of it the new engine's cold start "
                f"{row['cold_s']:.3f} s and its captures (first dispatch per bucket) "
                f"{row['capture_s']:.3f} s, graphs re-captured {row['graphs']}; answers "
                f"byte-equal; memory_allocated {mem0 / 2**20:.1f} MiB before the breaker's "
                f"recovery, {row['mem'] / 2**20:.1f} MiB after this one (one engine's weights "
                f"{weights / 2**20:.1f} MiB); live objects before {census0}, after "
                f"{row['census']}")
        out.update(cycles=cycles, mem0=mem0, weights=weights,
                   breaker_recovery_s=breaker_recovery_s, breaker_mem=breaker_row["mem"])

        # 6. Drain with a :generate stream in flight (its segments slowed so
        # that the drain overlaps it).
        faults = server.engine.runner.faults
        faults.configure(model="gpt2", latency_ms=100)
        sched = server.schedulers["gpt2"]
        with ThreadPoolExecutor(2) as ex:
            stream = ex.submit(sse, port, "gpt2", gen_body)
            wait_until(lambda: sched.active, 60, "the stream's admission", every=0.002)
            drain = ex.submit(http_h, port, "/admin/drain", {"timeout_s": 60})
            wait_until(lambda: server.draining, 10, "the drain", every=0.002)
            refused = http_h(port, bert, bodies[0])
            health = http_h(port, "/healthz")
            r, drained = stream.result(), drain.result()
        faults.clear()
        check(refused[0] == 503 and refused[1].get("draining") is True
              and "Retry-After" in refused[2], f"drain: a new :predict answered {refused[:2]}")
        check(health[0] == 503 and health[1]["draining"] is True,
              f"drain: /healthz answered {health[0]}")
        check(r["status"] == 200 and r["final"]["done"] and r["tokens"] == free[-1],
              "drain: the in-flight stream did not finish whole")
        check(drained[0] == 200 and drained[1]["drained"] is True, f"drain: {drained[:2]}")
        log(f"{card}: check 6 drain: the in-flight stream finished whole ({len(r['tokens'])} "
            "tokens, byte-equal); a new :predict 503 with draining and Retry-After; /healthz 503")

        # 7. Prometheus against the manifest.
        status, text, hdrs = http_h(port, "/metrics?format=prometheus")
        check(status == 200 and hdrs.get("Content-Type", "").startswith(
            "text/plain; version=0.0.4"), f"prometheus: status {status}, headers {hdrs}")
        tool = check_metrics_tool()
        problems = tool.check(text, tool.load_manifest())
        check(not problems, f"prometheus: {problems}")
        families = tool.parse_exposition(text)[0]
        for family in ("tpuserve_dispatch_retries_total", "tpuserve_deadline_exceeded_total",
                       "tpuserve_breaker_state", "tpuserve_recoveries_total", "tpuserve_draining",
                       "tpuserve_faults_injected_total", "tpuserve_ttft_ms",
                       "tpuserve_tokens_streamed_total", "tpuserve_device_ms"):
            check(family in families, f"prometheus: no {family}")
        recoveries = 1 + FAIL_POISON_CYCLES  # the breaker's and each poison's
        check(f"tpuserve_recoveries_total {recoveries}" in text and "tpuserve_draining 1" in text,
              "prometheus: the recoveries or the drain are not in the exposition")
        log(f"{card}: check 7 prometheus: {len(families)} families, every family and label set "
            "declared in tools/metrics_manifest.json (tools/check_metrics.py)")
        if cuda:
            # What the memory above holds beyond Python's reach: cuBLAS's
            # per-(handle, stream) workspaces, read by freeing them after the
            # last check (no graph replays after this).
            gc.collect()
            held = torch.cuda.memory_allocated()
            torch._C._cuda_clearCublasWorkspaces()
            out["workspaces_mib"] = (held - torch.cuda.memory_allocated()) / 2**20
            log(f"{card}: cuBLAS workspaces held {out['workspaces_mib']:.1f} MiB of the "
                f"{held / 2**20:.1f} MiB allocated after the last check")
    return out


def run_failure(card: str) -> dict:
    fresh_memory()
    t0 = time.perf_counter()
    out = phase_failure_path(failure_config(), card=card)
    log(f"{card}: failure path (phase 14) in {time.perf_counter() - t0:.3f} s; peak "
        f"allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return out


# -- phase 15: serverless residency ---------------------------------------------

# The deployment phase 15 serves: BERT-base int8 pinned, GPT-2 small int8 and
# ResNet-50 bf16 lazy, over a checkpoint store; the :generate lane as phase 14's.
RES_GEN = {"gen_slots": 8, "segment_tokens": 8, "max_new_tokens": 32}
RES_VISION = (1, 8)
# Check 2's deadline, below any activation estimate.
RES_DEADLINE_MS = 50
# Check 3: BERT requests sent while GPT-2 activates, from this many threads,
# each pausing between its requests so that they span the activation.
RES_BERT_REQS = 200
RES_BERT_THREADS = 8
RES_BERT_PAUSE_S = 0.3
# Check 7: demote/restore cycles of each lazy model, and the leak allowance.
RES_CYCLES = 2
RES_LEAK_BYTES = 8 << 20
# Check 8: the reaper's timers (the cold ladder with a store ends on disk).
RES_IDLE_S = 2.0
RES_HOST_DROP_S = 4.0
RES_TICK_S = 0.25
# Check 1: what memory_allocated may hold after boot beyond BERT's ledger
# entry (its graphs' static inputs, cuBLAS workspaces).
RES_BOOT_OVERHEAD = 64 << 20


def residency_config(store_dir: str, bert_arch: dict | None = None,
                     gpt2_arch: dict | None = None, image_size: int = VISION_SIZE,
                     resnet_arch: dict | None = None, **gpt2_extra):
    """Phase 15's deployment: BERT-base int8 PINNED at (1, 8) x 128, GPT-2
    small int8 lazy with its 8-slot :generate lane and :predict at (1,) x 64,
    ResNet-50 bf16 lazy at (1, 8), over a checkpoint store.  The HBM budget
    is set by the phase once the sizes are known."""
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig

    return ServeConfig(ckpt_store_dir=store_dir, models=[
        ModelConfig(name="bert_base", dtype="bfloat16", seq_buckets=(BERT["seq"],),
                    batch_buckets=BERT["batch_buckets"], pinned=True,
                    extra={"params_dtype": "int8", **({"arch": bert_arch} if bert_arch else {})}),
        ModelConfig(name="gpt2", dtype="bfloat16", seq_buckets=(GPT2["seq"],), batch_buckets=(1,),
                    lazy_load=True,
                    extra={"params_dtype": "int8", **RES_GEN,
                           **({"arch": gpt2_arch} if gpt2_arch else {}), **gpt2_extra}),
        ModelConfig(name="resnet50", dtype="bfloat16", batch_buckets=RES_VISION, lazy_load=True,
                    extra={"image_size": image_size, "resize_to": image_size + 32,
                           "params_dtype": "bfloat16",
                           **({"arch": resnet_arch} if resnet_arch else {})})])


def host_param_bytes(mc) -> int:
    """The weight bytes of ``mc``'s servable, built on the host alone (what
    its activation will place): each distinct parameter and buffer once."""
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_servable

    seen, total = set(), 0
    for m in build_servable(mc).module.modules():
        for t in (*m._parameters.values(), *m._buffers.values()):
            if t is not None and id(t) not in seen:
                seen.add(id(t))
                total += t.numel() * t.element_size()
    return total


def pinned_bytes(cm) -> int:
    return sum(t.numel() * t.element_size() for t in cm._tensors().values() if t.is_pinned())


def phase_residency_path(cfg, device: str = "cuda", bert_vocab: int = 30522,
                         gpt2_vocab: int = 50257, card: str = "") -> dict:
    """Serve the residency deployment over HTTP and check, in order: lazy
    boot and one activation for eight concurrent cold requests (byte-equal
    to an eagerly built model), cold admission's 503, the HBM budget
    demoting the LRU model and never the pinned one while BERT keeps
    answering, the host and disk restores and the stream during a rebuild
    (byte-equal answers, new captures), a torn stream degrading to the full
    rebuild, no memory left behind by demote/restore cycles, the idle
    reaper, and the Prometheus families."""
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_model
    from pytorch_zappa_serverless_tpu_torch.ops import counters
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    cuda = torch.device(device).type == "cuda"
    rng = np.random.default_rng(15)
    bert_bodies = [{"input_ids": rng.integers(1, bert_vocab - 1, n).tolist()}
                   for n in (5, 40, 90, 120)]
    gpt2_body = {"input_ids": rng.integers(0, gpt2_vocab - 1, 24).tolist()}
    gen_body = {"input_ids": rng.integers(0, gpt2_vocab - 1, 16).tolist(), "max_new_tokens": 24}
    size = cfg.model("resnet50").extra["image_size"]
    pngs = vision_pngs(8, seed=15)
    bert, gpt2 = "/v1/models/bert_base:predict", "/v1/models/gpt2:predict"
    resnet = "/v1/models/resnet50:predict"
    out: dict = {}

    def mem() -> tuple[int, int]:
        return ((torch.cuda.memory_allocated(), torch.cuda.memory_reserved()) if cuda
                else (0, 0))

    reset_counts()
    t0 = time.perf_counter()
    with BackgroundServer(cfg, device=device) as srv:
        server, port = srv.server, srv.port
        lc, engine = server.lifecycle, server.engine
        run = engine.runner.run_fn_sync

        def model(name: str) -> dict:
            return http_h(port, f"/admin/models/{name}")[1]["model"]

        def admin(name: str, **body) -> dict:
            status, o, _ = http_h(port, f"/admin/models/{name}", body)
            check(status == 200, f"admin {name} {body}: {status} {o}")
            return o["model"]

        def answers(name: str) -> list:
            """What must come back byte-equal after each restore: BERT's
            bodies; GPT-2's :predict and a greedy :generate stream sent
            alone; two ResNet-50 PNGs one at a time."""
            got = []
            if name == "bert_base":
                reqs = [(bert, b) for b in bert_bodies]
            elif name == "gpt2":
                reqs = [(gpt2, gpt2_body)]
            else:
                reqs = []
                for png in pngs[:2]:
                    status, o, _ = http_h(port, resnet, {"b64": base64.b64encode(png).decode()})
                    check(status == 200, f"{resnet}: {status}: {o}")
                    got.append(json.dumps(o["predictions"], sort_keys=True))
            for path, body in reqs:
                status, o, _ = http_h(port, path, body)
                check(status == 200, f"{path}: {status}: {o}")
                got.append(json.dumps(o["predictions"], sort_keys=True))
            if name == "gpt2":
                r = sse(port, "gpt2", gen_body)
                check(r["status"] == 200 and r["final"] and r["final"]["done"],
                      f"gpt2 :generate answered {r}")
                got.append(r["tokens"])
            return got

        # 1. Lazy boot: BERT alone; eight concurrent cold requests, one
        # activation, byte-equal to a ResNet-50 built eagerly.
        check(sorted(engine.models) == ["bert_base"], f"boot built {sorted(engine.models)}")
        ledger = engine.runner.resident_bytes()
        bert_res = ledger["bert_base"]
        boot_mem = mem()
        if cuda:
            check(boot_mem[0] <= bert_res + RES_BOOT_OVERHEAD,
                  f"boot: memory_allocated {boot_mem[0]} against BERT's resident bytes "
                  f"{bert_res} plus {RES_BOOT_OVERHEAD}")
        boot_s = time.perf_counter() - t0
        bert_free = answers("bert_base")
        bodies = [{"b64": base64.b64encode(p).decode()} for p in pngs]
        with ThreadPoolExecutor(len(bodies)) as ex:
            served = list(ex.map(lambda b: http_h(port, resnet, b), bodies))
        check(all(st == 200 for st, _, _ in served), f"cold burst: {[st for st, _, _ in served]}")
        rn = model("resnet50")
        check(rn["activations_by_cause"] == {"request": 1},
              f"cold burst: activations {rn['activations_by_cause']}")
        rcm = engine.model("resnet50")
        ref = run(build_model, cfg.model("resnet50"), engine.clock, engine.device)
        try:
            samples = [ref.servable.preprocess(p) for p in pngs]
            whole = run(ref.run_batch, samples)[0]
            for i, (_, o, _) in enumerate(served):
                want = (whole[i] if o["timing"]["batch_size"] > 1
                        else run(ref.run_batch, [samples[i]])[0][0])
                check(json.dumps(o["predictions"], sort_keys=True)
                      == json.dumps(want, sort_keys=True),
                      f"cold burst: answer {i} differs from the eagerly built ResNet-50")
        finally:
            run(ref.release)
            del ref
        resnet_res = engine.runner.resident_bytes()["resnet50"]
        resnet_params = rcm.param_nbytes()
        resnet_before = answers("resnet50")
        out["resnet_cold_ms"] = rn["last_activation_ms"]
        log(f"{card}: check 1 lazy boot: only bert_base built at boot ({boot_s:.3f} s; "
            f"resident {bert_res} bytes, memory_allocated {boot_mem[0]}); 8 concurrent cold "
            f"ResNet-50 requests, 1 activation in {rn['last_activation_ms']:.3f} ms "
            f"(phases {rn['last_activation_phases']}); the 8 answers byte-equal to a ResNet-50 "
            f"built eagerly from the same seed; resident {resnet_res} bytes of which weights "
            f"{resnet_params} and graph pool {resnet_res - resnet_params}")

        # 2. Cold admission: a deadline below GPT-2's estimate answers 503
        # and launches nothing for it; the activation it started goes on.
        est = model("gpt2")["estimated_warm_ms"]
        gpt2_params = host_param_bytes(cfg.model("gpt2"))
        # BERT plus either lazy model fits (GPT-2's graph pool is smaller
        # than ResNet-50's resident bytes; checked below), all three do not.
        budget = bert_res + resnet_res + gpt2_params - 1
        server.cfg.hbm_budget_bytes = budget
        reset_counts()
        status, o, hdrs = http_h(port, gpt2, gpt2_body, {"X-Deadline-Ms": str(RES_DEADLINE_MS)})
        counts = read_counts()
        check(status == 503 and o.get("cold_start") is True and "Retry-After" in hdrs
              and o["estimated_warm_ms"] > RES_DEADLINE_MS,
              f"cold admission: {status} {o} {hdrs}")
        exact_counts(counts, {}, "cold admission")
        log(f"{card}: check 2 cold admission: X-Deadline-Ms {RES_DEADLINE_MS} below the "
            f"estimate {est} ms: 503 cold_start, Retry-After {hdrs['Retry-After']}, "
            f"estimated_warm_ms {o['estimated_warm_ms']}; no launch for it")

        # 3. The budget: GPT-2's activation (started by the 503) demotes the
        # LRU ResNet-50 to the host; BERT, pinned, answers throughout.
        t1 = time.perf_counter()

        def bert_load(i: int) -> list:
            lat = []
            for j in range(RES_BERT_REQS // RES_BERT_THREADS):
                body = bert_bodies[(i + j) % len(bert_bodies)]
                t = time.perf_counter()
                st, o, _ = http_h(port, bert, body)
                # A lone request runs at bucket 1, as bert_free's did; a
                # co-batched one at bucket 8, whose numbers differ.
                alone = st == 200 and o["timing"]["batch_size"] == 1
                lat.append((st, (time.perf_counter() - t) * 1e3, t - t1,
                            json.dumps(o["predictions"], sort_keys=True) if alone else None))
                time.sleep(RES_BERT_PAUSE_S)
            return lat

        with ThreadPoolExecutor(RES_BERT_THREADS) as ex:
            lats = [x for part in ex.map(bert_load, range(RES_BERT_THREADS)) for x in part]
        wait_until(lambda: lc.state_of("gpt2") == "active", 600, "GPT-2's activation")
        g = model("gpt2")
        # The activation began at the 503, just before t1.
        activation_s = g["last_activation_ms"] / 1e3
        check(all(st == 200 for st, _, _, _ in lats) and len(lats) == RES_BERT_REQS,
              f"budget: BERT statuses {sorted(set(st for st, _, _, _ in lats))}")
        alone = [a for _, _, _, a in lats if a is not None]
        check(all(a in bert_free for a in alone), "budget: a lone BERT answer differs")
        during = [ms for _, ms, at, _ in lats if at < activation_s]
        all_ms = sorted(ms for _, ms, _, _ in lats)
        rn = model("resnet50")
        ledger = engine.runner.resident_bytes()
        check(rn["state"] == "cold" and rn["tier"] == "host"
              and rn["demotions_by_cause"] == {"budget": 1},
              f"budget: ResNet-50 is {rn['state']}/{rn['tier']} {rn['demotions_by_cause']}")
        check(model("bert_base")["state"] == "active" and lc.residency("bert_base").pinned
              and model("bert_base")["activations"] == 1,
              "budget: the pinned BERT was touched")
        gpt2_res = ledger["gpt2"]
        check(bert_res + gpt2_res <= budget < bert_res + gpt2_res + resnet_res,
              f"budget {budget}: BERT {bert_res} + GPT-2 {gpt2_res} + ResNet-50 {resnet_res}")
        freed = rn["last_demotion"]
        if cuda:
            # memory_allocated counts the weights (and the graphs' live
            # outputs) but not a graph pool's free blocks, which only the
            # reserved bytes show: the pool's segments are its own and go
            # whole, where a weight's segment may hold another model's
            # tensors and stay.
            check(freed["freed_allocated"] >= resnet_params
                  and freed["freed_reserved"] >= resnet_res - resnet_params,
                  f"budget: the demotion freed {freed}, ResNet-50 held {resnet_res} "
                  f"({resnet_params} weights)")
        gpt2_free = answers("gpt2")
        out.update(gpt2_cold_ms=g["last_activation_ms"], budget=budget,
                   bert_during_ms=(statistics.median(during) if during else None),
                   resnet_freed=freed, resident={"bert_base": bert_res, "gpt2": gpt2_res,
                                                 "resnet50": resnet_res})
        log(f"{card}: check 3 budget {budget} bytes: GPT-2 activated in "
            f"{g['last_activation_ms']:.3f} ms (phases {g['last_activation_phases']}; "
            f"resident {gpt2_res}); ResNet-50 demoted to the host by the budget, freeing "
            f"{freed}; BERT (pinned) untouched; {len(lats)} BERT requests 200 ({len(alone)} "
            f"alone at bucket 1, byte-equal to before), "
            f"{len(during)} of them while GPT-2 activated: p50 "
            f"{(statistics.median(during) if during else float('nan')):.3f} ms, p99 "
            f"{(np.percentile(during, 99) if during else float('nan')):.3f} ms; all: p50 "
            f"{statistics.median(all_ms):.3f} ms, p99 {np.percentile(all_ms, 99):.3f} ms, max "
            f"{all_ms[-1]:.3f} ms")

        # 4. The host tier: ResNet-50 restored from pinned host copies.
        captures = rcm.captures
        check(answers("resnet50") == resnet_before, "host: ResNet-50's answers differ")
        rn = model("resnet50")
        new = len(rcm.buckets) if rcm.graphed else 0  # the CPU captures nothing
        check(engine.model("resnet50") is rcm and rcm.captures == captures + new,
              f"host: captures {captures} -> {rcm.captures} over {len(rcm.buckets)} buckets")
        ph = rn["last_activation_phases"]
        out["resnet_host"] = {"ms": rn["last_activation_ms"], **ph}
        log(f"{card}: check 4 host tier: ResNet-50 restored in {rn['last_activation_ms']:.3f} "
            f"ms (H2D {ph['load_ms']:.3f} ms, captures {ph['compile_ms']:.3f} ms; cold "
            f"activation {out['resnet_cold_ms']:.3f} ms); answers byte-equal; "
            f"{new} new captures")

        # 5. The disk tier: GPT-2 to the store and back by stream; then a torn
        # stream degrades to the full rebuild.
        g = admin("gpt2", action="demote", to="disk")
        check(g["tier"] == "disk" and g["host_bytes"] == 0 and g["disk_bytes"] > 0
              and lc.residency("gpt2").cm_host.tier == "disk",
              f"disk: GPT-2 is {g['tier']} (host {g['host_bytes']}, disk {g['disk_bytes']})")
        check(answers("gpt2") == gpt2_free, "disk: GPT-2's answers or tokens differ")
        g = model("gpt2")
        ph = g["last_activation_phases"]
        check(ph["tier"] == "disk" and ph.get("streamed") is True,
              f"disk: the restore did not stream: {ph}")
        out["gpt2_disk"] = {"ms": g["last_activation_ms"], **ph}
        admin("gpt2", action="demote", to="disk")
        engine.runner.faults.configure(model="gpt2", kind="ckpt", mode="torn", fail_every_n=1)
        degraded0 = lc.store.snapshot()["degraded_loads_total"]
        check(answers("gpt2") == gpt2_free, "torn: the rebuilt GPT-2's answers differ")
        engine.runner.faults.clear("gpt2")
        g = model("gpt2")
        check(lc.store.snapshot()["degraded_loads_total"] == degraded0 + 1
              and g["last_activation_phases"].get("streamed") is not True,
              f"torn: degraded {lc.store.snapshot()['degraded_loads_total']}, "
              f"phases {g['last_activation_phases']}")
        out["gpt2_torn"] = {"ms": g["last_activation_ms"], **g["last_activation_phases"]}
        log(f"{card}: check 5 disk tier: GPT-2 to the store (host copy freed) and back by "
            f"stream in {out['gpt2_disk']['ms']:.3f} ms ({ph['chunks_streamed']} chunks "
            f"streamed, load {ph['load_ms']:.3f} ms, captures {ph['compile_ms']:.3f} ms); "
            f":predict and the greedy :generate stream byte-equal; a torn chunk on every "
            f"read degraded to the full rebuild ({out['gpt2_torn']['ms']:.3f} ms), byte-equal")

        # 6. Stream while building: from none, the stored weights copied in
        # place under the captured addresses before the first replay.
        admin("gpt2", action="demote", to="none")
        check(answers("gpt2") == gpt2_free, "stream-while-build: GPT-2's answers differ")
        g = model("gpt2")
        ph = g["last_activation_phases"]
        check(ph["tier"] == "none" and ph.get("streamed") is True,
              f"stream-while-build: {ph}")
        out["gpt2_none"] = {"ms": g["last_activation_ms"], **ph}
        log(f"{card}: check 6 stream while building: GPT-2 from none in "
            f"{g['last_activation_ms']:.3f} ms (build and captures {ph['compile_ms']:.3f} ms, "
            f"the stream {ph['load_ms']:.3f} ms beside them, {ph['chunks_streamed']} chunks); "
            "answers byte-equal")

        # 7. No leak: with the budget lifted, both lazy models resident, three
        # host and disk cycles each come back to the same memory and objects.
        server.cfg.hbm_budget_bytes = 0
        answers("resnet50")
        gc.collect()
        base, census0 = mem(), device_census()
        cycles = []
        for cycle in range(RES_CYCLES):
            row = {}
            for name, free in (("resnet50", resnet_before), ("gpt2", gpt2_free)):
                for to in ("host", "disk"):
                    m = admin(name, action="demote", to=to)
                    cm = lc.residency(name).cm_host
                    if to == "host":
                        check(lc.host_bytes()[name] == m["host_bytes"] == cm.param_nbytes()
                              and (not cuda or pinned_bytes(cm) == m["host_bytes"]),
                              f"{name}: host_bytes {lc.host_bytes()} against pinned "
                              f"{pinned_bytes(cm)}")
                    check(answers(name) == free, f"cycle {cycle} {name} {to}: answers differ")
                    row[f"{name}_{to}_ms"] = model(name)["last_activation_ms"]
            gc.collect()
            row["mem"], row["census"] = mem(), device_census()
            cycles.append(row)
        if cuda:
            check(abs(cycles[-1]["mem"][0] - base[0]) <= RES_LEAK_BYTES,
                  f"leak: memory_allocated {cycles[-1]['mem'][0]} after {RES_CYCLES} cycles, "
                  f"{base[0]} before")
        check(cycles[-1]["census"]["models"] == census0["models"],
              f"leak: {cycles[-1]['census']} live after the cycles, {census0} before")
        out["cycles"] = cycles
        log(f"{card}: check 7 no leak: {RES_CYCLES} host and disk cycles of ResNet-50 and "
            f"GPT-2, answers byte-equal every time; memory_allocated {base[0]} before, "
            f"{[c['mem'][0] for c in cycles]} after each cycle (reserved {base[1]}, "
            f"{[c['mem'][1] for c in cycles]}); live objects {census0} before, "
            f"{cycles[-1]['census']} after; host bytes match the pinned copies; restore ms "
            f"{[{k: v for k, v in c.items() if k.endswith('_ms')} for c in cycles]}")

        # 8. Idle scale-to-zero: the reaper takes ResNet-50 to the host, then
        # (a store being set) to disk; a request brings it back.
        server.cfg.idle_unload_s = RES_IDLE_S
        server.cfg.host_idle_drop_s = RES_HOST_DROP_S
        server.cfg.lifecycle_tick_s = RES_TICK_S
        srv.call(lc.start)
        admin("gpt2", action="pin")  # only the ResNet-50 idles
        t1 = time.perf_counter()
        wait_until(lambda: lc.residency("resnet50").tier == "host", 30, "the idle demotion")
        host_s = time.perf_counter() - t1
        wait_until(lambda: lc.residency("resnet50").tier == "disk", 30, "the host-tier drop")
        disk_s = time.perf_counter() - t1
        check(answers("resnet50") == resnet_before, "idle: the re-activated answers differ")
        rn = model("resnet50")
        check(rn["demotions_by_cause"].get("idle") == 2
              and rn["activations_by_cause"].get("request", 0) >= 2,
              f"idle: {rn['demotions_by_cause']} {rn['activations_by_cause']}")
        admin("gpt2", action="unpin")
        srv.call(lc.stop)
        log(f"{card}: check 8 idle: ResNet-50 idle {host_s:.3f} s -> host tier "
            f"(idle_unload_s {RES_IDLE_S}), {disk_s:.3f} s -> disk (host_idle_drop_s "
            f"{RES_HOST_DROP_S}); a request re-activated it from disk in "
            f"{rn['last_activation_ms']:.3f} ms, byte-equal")

        # 9. Prometheus against the manifest.
        status, text, hdrs = http_h(port, "/metrics?format=prometheus")
        check(status == 200, f"prometheus: {status}")
        tool = check_metrics_tool()
        problems = tool.check(text, tool.load_manifest())
        check(not problems, f"prometheus: {problems}")
        families = tool.parse_exposition(text)[0]
        for family in ("tpuserve_residency_state", "tpuserve_residency_tier_bytes",
                       "tpuserve_activations_total", "tpuserve_activation_ms",
                       "tpuserve_hbm_bytes", "tpuserve_ckpt_chunks_streamed_total",
                       "tpuserve_ckpt_dedup_hits_total", "tpuserve_ckpt_load_ms",
                       "tpuserve_demotions_total", "tpuserve_cold_start_fast_fails_total"):
            check(family in families, f"prometheus: no {family}")
        log(f"{card}: check 9 prometheus: {len(families)} families, the residency and store "
            "families among them, every family and label set declared in "
            "tools/metrics_manifest.json (tools/check_metrics.py)")
    counts, graphed = read_counts(), counters.graphed()
    # Every launch of the path ran in a captured graph's warm-up or replay.
    exact_counts(counts, graphed, "residency path")
    if cuda:
        check(counts["int8_matmul"] > 0, "residency path: no int8_matmul launch")
    out["launches"] = counts["int8_matmul"]
    out["seconds"] = time.perf_counter() - t0
    log(f"{card}: residency path int8_matmul launches {counts['int8_matmul']}, each in a "
        f"captured graph's warm-up or replay ({graphed['int8_matmul']})")
    return out


def run_residency(card: str) -> dict:
    import tempfile

    fresh_memory()
    with tempfile.TemporaryDirectory(prefix="tpuserve-store-") as store:
        out = phase_residency_path(residency_config(store), card=card)
    log(f"{card}: residency path (phase 15) in {out['seconds']:.3f} s; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return out


# -- phase 16: the request plane -----------------------------------------------

PLANE_BERT = (1, 8)        # BERT-base int8 batch buckets, at seq 128
PLANE_VISION = (1, 8)      # ResNet-50 bf16 batch buckets, at 224x224
PLANE_GEN = {"gen_slots": 8, "segment_tokens": 8, "max_new_tokens": 16}
PLANE_REQS = 40            # sequential requests a lane for the client p50
PLANE_TRACED = 16          # sequential traceparent-joined BERT requests, check 2
PLANE_PROFILE_S = 1.0
PLANE_SD_JOBS = 4          # the kill -9 test's journaled SD-1.5 jobs
PLANE_SD_LATENCY_MS = 250  # injected a dispatch slice in the first process


def plane_config(trace_dir: str, bert_arch: dict | None = None,
                 gpt2_arch: dict | None = None, image_size: int = VISION_SIZE, **gpt2_extra):
    """BERT-base int8 (1, 8) x 128, ResNet-50 bf16 (1, 8) and GPT-2 small
    int8 with an 8-slot :generate lane, one server."""
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig

    return ServeConfig(trace_dir=trace_dir, models=[
        ModelConfig(name="bert_base", dtype="bfloat16", seq_buckets=(BERT["seq"],),
                    batch_buckets=PLANE_BERT,
                    extra={"params_dtype": "int8", **({"arch": bert_arch} if bert_arch else {})}),
        ModelConfig(name="resnet50", dtype="bfloat16", batch_buckets=PLANE_VISION,
                    extra={"image_size": image_size, "resize_to": image_size * 8 // 7}),
        ModelConfig(name="gpt2", dtype="bfloat16", seq_buckets=(16, 64),
                    batch_buckets=(1,),
                    extra={"params_dtype": "int8", **PLANE_GEN, **gpt2_extra,
                           **({"arch": gpt2_arch} if gpt2_arch else {})})])


def http_b(port: int, path: str, data: bytes | None, headers: dict | None = None,
           method: str = "POST", timeout: float = 120.0):
    """(status, raw body, headers) of one request."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def find_span(node: dict, name: str) -> dict | None:
    if node["name"] == name:
        return node
    for c in node.get("children", []):
        hit = find_span(c, name)
        if hit is not None:
            return hit
    return None


def phase_plane_path(cfg, device: str = "cuda", bert_vocab: int = 30522,
                     gpt2_vocab: int = 50257, reqs: int = PLANE_REQS) -> dict:
    """Serve the plane's models over HTTP and check, in order: (1) the
    binary lane against the JSON lane (predictions byte-decode equal, single
    and 8-instance requests, BERT and ResNet-50; the client p50 of each
    lane, ResNet-50's on the same crop as a nested JSON list too; 400 with both ids for a truncated frame, 413 for a declared
    oversize, 415 with the lane off; every int8_matmul launch in a graph's
    replay); (2) tracing (ids on every answer, a given one echoed, a
    traceparent joining its trace, a BERT trace's admission → queue →
    batch → device → exec tree for each of PLANE_TRACED requests, whose exec
    span lies inside the answer's ``X-Device-Ms`` after its lane wait and
    covers at least half of it at the median, the root covering its chain
    and inside the client's round trip, a
    GPT-2 int8 stream named by its request id, a 400 with both ids); (3)
    ``/admin/profile`` over BERT traffic naming int8_matmul's kernel, a
    second capture meanwhile 409, and a ResNet-50 restore from the host tier
    captured while the profile is open, answering byte-equal."""
    from pytorch_zappa_serverless_tpu_torch.ops import counters
    from pytorch_zappa_serverless_tpu_torch.serving import wire
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    cuda = torch.device(device).type == "cuda"
    tensor = {"Content-Type": wire.TENSOR_CONTENT_TYPE}
    rng = np.random.default_rng(16)
    bert_ids = [rng.integers(1, bert_vocab - 1, n).tolist() for n in (7, 30, 64, 90, 120, 12,
                                                                      45, 128)]
    pngs = vision_pngs(8, seed=16)
    out: dict = {"ids": [], "p50": {}}
    bert = "/v1/models/bert_base:predict"
    resnet = "/v1/models/resnet50:predict"

    def note_ids(h: dict, what: str):
        check(h.get("X-Request-Id") and h.get("X-Trace-Id"),
              f"{what}: answer without X-Request-Id / X-Trace-Id: {h}")
        out["ids"].append(h["X-Trace-Id"])

    t0 = time.perf_counter()
    with BackgroundServer(cfg, device=device) as srv:
        port, server = srv.port, srv.server
        cm_resnet = server.engine.model("resnet50")
        pixels = [cm_resnet.servable.preprocess(png)["image"] for png in pngs]
        reset_counts()
        # -- check 1: the binary lane against the JSON lane ----------------------
        for name, path, json_bodies, frames in (
                ("bert_base", bert, [{"input_ids": ids} for ids in bert_ids],
                 [{"input_ids": ids} for ids in bert_ids]),
                ("resnet50", resnet, [{"b64": base64.b64encode(p).decode()} for p in pngs],
                 pixels)):
            for single in (True, False):
                jb = json_bodies[0] if single else {"instances": json_bodies}
                status, raw, h = http_b(port, path, json.dumps(jb).encode(),
                                        {"Content-Type": "application/json"})
                check(status == 200, f"{name} JSON lane: {status} {raw[:200]}")
                note_ids(h, f"{name} JSON")
                want = json.loads(raw)["predictions"]
                frame = bytes(wire.pack(frames[:1] if single else frames,
                                        flags=0 if single else wire.FLAG_LIST))
                status, raw, h = http_b(port, path, frame, tensor)
                check(status == 200 and h["Content-Type"] == wire.TENSOR_CONTENT_TYPE,
                      f"{name} binary lane: {status} {h} {raw[:200]}")
                note_ids(h, f"{name} binary")
                meta, preds = wire.unpack_response(raw)
                got = preds[0] if single else preds
                check(json.dumps(got) == json.dumps(want),
                      f"{name} binary lane predictions differ from the JSON lane's "
                      f"({'single' if single else '8 instances'})")
                check(meta["model"] == name and "timing" in meta, f"{name} meta {meta}")
            # The client p50 a lane, single requests in turn.  The lanes
            # compared carry the same work: ResNet-50's binary frame is the
            # 224x224 crop, so its JSON twin is the same crop as a nested
            # list ("json crop"); "json" is the base64 PNG, which the server
            # also decodes and resizes inside the request.
            lanes = [("json", json.dumps(json_bodies[1]).encode(),
                      {"Content-Type": "application/json"}),
                     ("binary", bytes(wire.pack(frames[1:2])), tensor)]
            if name == "resnet50":
                crop = json.dumps(pixels[1].tolist()).encode()
                status, raw, _ = http_b(port, path, crop, {"Content-Type": "application/json"})
                status_b, raw_b, _ = http_b(port, path, lanes[1][1], tensor)
                check(status == 200 and status_b == 200 and json.dumps(
                    json.loads(raw)["predictions"]) == json.dumps(
                    wire.unpack_response(raw_b)[1][0]),
                      f"resnet50 JSON crop lane differs from the binary lane: {status} "
                      f"{raw[:200]}")
                lanes.insert(1, ("json crop", crop, {"Content-Type": "application/json"}))
            for lane, data, hdrs in lanes:
                times = []
                for _ in range(reqs):
                    t = time.perf_counter()
                    status, _, _ = http_b(port, path, data, hdrs)
                    times.append((time.perf_counter() - t) * 1e3)
                    check(status == 200, f"{name} {lane} p50 request: {status}")
                out["p50"][f"{name} {lane}"] = statistics.median(times)
        good = bytes(wire.pack(pixels[:1]))
        status, raw, h = http_b(port, resnet, good[:-100], tensor)
        body = json.loads(raw)
        check(status == 400 and "truncated" in body["error"] and body["request_id"]
              == h["X-Request-Id"] and body["trace_id"] == h["X-Trace-Id"],
              f"truncated frame: {status} {body}")
        oversize = (wire._HDR.pack(wire.MAGIC, wire.VERSION, 0, 1) + wire._BLK.pack(9, 2, 0)
                    + wire._DIM.pack(60000) + wire._DIM.pack(60000))
        status, raw, _ = http_b(port, resnet, oversize, tensor)
        check(status == 413 and json.loads(raw)["trace_id"], f"declared oversize: {status} {raw}")
        server.cfg.binary_lane = False
        try:
            status, raw, _ = http_b(port, resnet, good, tensor)
        finally:
            server.cfg.binary_lane = True
        check(status == 415 and json.loads(raw)["request_id"], f"lane off: {status} {raw}")
        counts, graphed = read_counts(), counters.graphed()
        # (A CPU wrapper runs its plain version and counts nothing.)
        check(not cuda or 0 < counts["int8_matmul"] == graphed["int8_matmul"],
              f"check 1: int8_matmul {counts['int8_matmul']} launches, "
              f"{graphed['int8_matmul']} of them in captured graphs")
        log(f"plane check 1: binary lane predictions equal to the JSON lane's (BERT int8 and "
            f"ResNet-50 bf16, single and 8 instances); client p50 "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in out["p50"].items())
            + f" ({reqs} sequential requests each); 400 / 413 / 415 with ids; "
            f"{counts['int8_matmul']} int8_matmul launches, all in graph replays")

        # -- check 2: tracing --------------------------------------------------------
        status, raw, h = http_b(port, bert, json.dumps({"input_ids": bert_ids[2]}).encode(),
                                {"Content-Type": "application/json", "X-Request-Id": "plane-7"})
        check(status == 200 and h["X-Request-Id"] == "plane-7", f"echo: {status} {h}")
        # PLANE_TRACED requests in turn, each joining a traceparent of its own.
        # Every one's exec span (the dispatch thread's replay and synchronize)
        # lies inside the batcher's device window, after its lane wait; the
        # rest of the window is the hop to the dispatch thread and back, host
        # time that one sample can catch behind another thread of the process,
        # so "exec is most of the window" is held on the median.
        sid = "0123456789abcdef"
        rows = []
        for i in range(PLANE_TRACED):
            tid = f"{i + 1:08x}" * 4
            t = time.perf_counter()
            status, raw, h = http_b(port, bert,
                                    json.dumps({"input_ids": bert_ids[3]}).encode(),
                                    {"Content-Type": "application/json",
                                     "traceparent": f"00-{tid}-{sid}-01"})
            client_ms = (time.perf_counter() - t) * 1e3
            check(status == 200 and h["X-Trace-Id"] == tid, f"traceparent: {status} {h}")
            device_ms = float(h["X-Device-Ms"])
            status, t, _ = http_h(port, f"/admin/trace/{tid}")
            check(status == 200, f"/admin/trace/{tid}: {status} {t}")
            tree = t["trace"]["tree"]
            check(t["trace"]["remote_parent"] == sid and t["trace"]["status"] == "ok",
                  f"trace {t['trace']}")
            kids = {c["name"]: c for c in tree["children"]}
            for stage in ("admission", "queue", "batch_form", "device", "respond"):
                check(stage in kids, f"BERT trace lacks {stage}: {sorted(kids)}")
            dev, ex = kids["device"], find_span(kids["device"], "exec")
            check(ex is not None and ex["attrs"]["lane"] == "latency", f"no exec span: {dev}")
            wait = ex["attrs"]["lane_wait_ms"]
            check(ex["start_ms"] + 0.002 >= dev["start_ms"] and ex["start_ms"]
                  + ex["duration_ms"] <= dev["start_ms"] + device_ms + 0.002
                  and wait + ex["duration_ms"] <= device_ms + 0.002,
                  f"exec {ex['duration_ms']} ms at {ex['start_ms']} after a lane wait of "
                  f"{wait} ms outside the device window {device_ms} ms at {dev['start_ms']}")
            # The server's root span lies inside the client's own clock.
            check(tree["duration_ms"] <= client_ms,
                  f"root {tree['duration_ms']} ms past the client's round trip {client_ms} ms")
            chain = sum(kids[s]["duration_ms"] for s in ("admission", "queue", "device",
                                                          "respond"))
            check(tree["duration_ms"] + 0.005 >= chain,
                  f"root {tree['duration_ms']} ms below its chain's sum {chain}")
            rows.append({**{s: kids[s]["duration_ms"] for s in ("admission", "queue",
                                                                 "batch_form", "device",
                                                                 "respond")},
                         "exec": ex["duration_ms"], "lane_wait": wait,
                         "hop_back": round(device_ms - wait - ex["duration_ms"], 3),
                         "root": tree["duration_ms"], "client": round(client_ms, 3)})
        share = statistics.median(r["exec"] / r["device"] for r in rows)
        check(share >= 0.5, f"exec the median {share:.3f} of the device window over "
                            f"{len(rows)} traced requests: {rows}")
        out["trace"] = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
        out["trace_spread"] = {k: [min(r[k] for r in rows), max(r[k] for r in rows)]
                               for k in ("device", "exec", "lane_wait", "hop_back")}
        out["trace"]["exec_share"] = round(share, 4)
        r = sse(port, "gpt2", {"input_ids": rng.integers(0, gpt2_vocab - 1, 12).tolist()})
        check(r["status"] == 200 and r["final"] and r["final"]["done"], f"gpt2 stream {r}")
        hs = r["headers"]
        check(hs["X-Stream-Id"] == hs["X-Request-Id"] and
              r["final"]["stats"]["trace_id"] == hs["X-Trace-Id"], f"stream ids {hs}")
        _, gt, _ = http_h(port, f"/admin/trace/{hs['X-Trace-Id']}")
        names = [c["name"] for c in gt["trace"]["tree"]["children"]]
        for stage in ("queue", "prefill", "first_segment", "decode", "finish"):
            check(stage in names, f"stream trace lacks {stage}: {names}")
        status, raw, h = http_b(port, bert, b'{"input_ids": [1, 2,',
                                {"Content-Type": "application/json"})
        body = json.loads(raw)
        check(status == 400 and body["request_id"] == h["X-Request-Id"]
              and body["trace_id"] == h["X-Trace-Id"], f"400 ids: {status} {body} {h}")
        log(f"plane check 2: every work answer carried X-Request-Id and X-Trace-Id "
            f"({len(out['ids'])} checked), a given id echoed, {PLANE_TRACED} traceparents "
            f"joined; BERT trace ms, the median of {PLANE_TRACED}: {out['trace']}, [min, max] "
            f"{out['trace_spread']}; threads {threading.active_count()}; the GPT-2 stream's "
            f"id is its request id; a 400 "
            f"carries both ids")

        # -- check 3: /admin/profile over traffic, and a restore under it ------------
        def resnet_answer() -> str:
            status, raw, _ = http_b(port, resnet, bytes(wire.pack(pixels[3:4])), tensor)
            check(status == 200, f"resnet50 binary answer: {status} {raw[:200]}")
            return json.dumps(wire.unpack_response(raw)[1])

        before = resnet_answer()
        status, o, _ = http_h(port, "/admin/models/resnet50", {"action": "demote", "to": "host"})
        check(status == 200 and o["model"]["tier"] == "host", f"demote: {status} {o}")
        res: dict = {}
        stop = threading.Event()

        def profile():
            res["first"] = http_h(port, "/admin/profile",
                                  {"seconds": PLANE_PROFILE_S, "top": 40})

        def traffic():
            body = json.dumps({"input_ids": bert_ids[4]}).encode()
            while not stop.is_set():
                http_b(port, bert, body, {"Content-Type": "application/json"})

        threads = [threading.Thread(target=profile), threading.Thread(target=traffic)]
        for th in threads:
            th.start()
        wait_until(lambda: server._tracing, 30, "the profile to open")
        second = http_h(port, "/admin/profile", {"seconds": 0.1})
        check(second[0] == 409, f"a second profile answered {second[0]}: {second[1]}")
        ta = time.perf_counter()
        status, o, _ = http_h(port, "/admin/models/resnet50", {"action": "activate"})
        restore_ms = (time.perf_counter() - ta) * 1e3
        check(status == 200 and o["model"]["tier"] == "device", f"restore: {status} {o}")
        check(server._tracing, "the restore outlasted the profile window: raise "
                               "PLANE_PROFILE_S")
        after = resnet_answer()
        threads[0].join(120)
        stop.set()
        threads[1].join(120)
        check(after == before, "ResNet-50 after its restore under the profile answers "
                               "other bytes")
        status, prof, _ = res["first"]
        check(status == 200, f"/admin/profile: {status} {prof}")
        kernel = [op for op in prof["ops"] if "w8a16" in op["op"]]
        if cuda:
            check(kernel, f"/admin/profile's ops name no int8_matmul kernel: "
                          f"{[op['op'][:60] for op in prof['ops']]}")
        out["profile"] = {"device_compute_ms": prof["device_compute_ms"],
                          "copy_ms": prof["copy_ms"], "ops": len(prof["ops"]),
                          "int8_matmul": kernel[:1], "restore_ms": restore_ms}
        log(f"plane check 3: /admin/profile {PLANE_PROFILE_S} s under BERT traffic: device "
            f"compute {prof['device_compute_ms']} ms, copies {prof['copy_ms']} ms; "
            f"int8_matmul's kernel {[(op['op'][:48], op['ms'], op['count']) for op in kernel]}; "
            f"a second capture 409; ResNet-50 restored from the host in {restore_ms:.1f} ms "
            f"(its captures under the open profile), answering byte-equal")
        out["counts"] = read_counts()
        out["graphed"] = counters.graphed()
        _, metrics, _ = http_h(port, "/metrics?format=prometheus")
    check_metrics = check_metrics_tool()
    problems = check_metrics.check(metrics, check_metrics.load_manifest())
    check(not problems, f"/metrics with exemplars against the manifest: {problems}")
    check('# {trace_id="' in metrics, "no exemplar on the histograms")
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_plane_crash(card: str, workdir: str, jobs: int = PLANE_SD_JOBS,
                      checkpoint: str | None = None) -> dict:
    """Phase 16 check 4: the port's kill -9 harness on the card with SD-1.5
    txt2img at 512x512, 20 steps: ``jobs`` journaled submits, a SIGKILL with
    a backlog, the restart; no acknowledged job lost, every resubmit
    deduped, a recovered job's PNG byte-equal to the same payload submitted
    fresh under a new key."""
    from pytorch_zappa_serverless_tpu_torch.tools import crashtest

    t0 = time.perf_counter()
    out = crashtest.run_crashtest(workdir, n_jobs=jobs, model="sd15", platform="cuda",
                                  latency_ms=PLANE_SD_LATENCY_MS, boot_timeout_s=400.0,
                                  finish_timeout_s=400.0, checkpoint=checkpoint)
    check(out["lost"] == 0 and out["completed"] == jobs, f"kill -9: {out}")
    check(out["backlog_at_kill"] >= 1 and out["recovered_jobs"] >= 1
          and out["recovered_jobs"] + out["restored_done"] == jobs, f"kill -9 replay: {out}")
    check(out["deduped_resubmits"] == jobs and out["deduped_submits_metric"] >= jobs,
          f"kill -9 dedupes: {out}")
    check(out["fresh_equal"] is True, "a recovered job's PNG differs from the same payload "
                                      "run fresh")
    flash = (out["launches_boot_at_kill"].get("flash_attention", 0)
             + out["launches_restart"].get("flash_attention", 0))
    unet = out["launches_restart"].get("unet_apply", 0)
    check(out["launches_restart"]["flash_attention"] == 10 * unet > 0,
          f"restarted server: flash {out['launches_restart']} != 10 a UNet call")
    out["flash_launches"] = flash
    out["seconds"] = time.perf_counter() - t0
    log(f"{card}: plane check 4 (kill -9, SD-1.5 512x512 20 steps, {jobs} jobs): boot "
        f"{out['boot_ready_s']} s, backlog at the kill {out['backlog_at_kill']}, restart "
        f"{out['restart_ready_s']} s, replay_ms {out['replay_ms']}, recovered "
        f"{out['recovered_jobs']} + restored {out['restored_done']}, lost {out['lost']}, "
        f"{out['deduped_resubmits']} resubmits deduped, the fresh PNG equal; job seconds "
        f"after the restart {out['job_seconds']}, fresh {out['fresh_seconds']}; flash "
        f"launches {flash} in the two server processes")
    return out


def run_plane(card: str, sd_checkpoint: str | None = None) -> dict:
    """Phase 16: the request plane (checks 1-4; check 5 ran on phase 6's
    engine); check 4's SD-1.5 servers boot from ``sd_checkpoint`` (phase
    22a's staged tree) when given."""
    import tempfile

    fresh_memory()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tpuserve-plane-") as tmp:
        run = phase_plane_path(plane_config(tmp + "/traces"))
        check(run["counts"]["flash_attention"] == 0, f"flash on the plane path: {run['counts']}")
        fresh_memory()
        crash = phase_plane_crash(card, tmp + "/crash", checkpoint=sd_checkpoint)
    log(f"{card}: request plane (phase 16) in {time.perf_counter() - t0:.3f} s: serving "
        f"checks {run['seconds']:.3f} s, kill -9 {crash['seconds']:.3f} s; SD job seconds "
        f"with prepare and finalize captured {SD_EDGES.get('captured', 0.0):.4f}, eager "
        f"{SD_EDGES.get('eager', 0.0):.4f}")
    return {"int8_launches": run["counts"]["int8_matmul"],
            "flash_launches": crash["flash_launches"], "serve": run, "crash": crash}


# -- phase 17: stream mobility and speculation ----------------------------------

# The paged lanes of phase 17: GPT-2 small int8 (16-token pages, 64-token
# chunks, 8 slots, 8-token segments, 32 new tokens), speculation with a
# draft of k = 4 proposals a tick.
MOB = {"seq_buckets": (16, 64, 128), "max_new_tokens": 32, "gen_slots": 8,
       "segment_tokens": 8, "block_size": 16, "chunk": 64, "spec_k": 4}
# The verify forward's rows: every slot's pending token and its proposals.
SPEC_M = MOB["gen_slots"] * (MOB["spec_k"] + 1)
MOB_SPEC_STREAMS = 8      # every other one sampled (GEN_SAMPLED)
MOB_MISMATCH_STREAMS = 8  # the spec_mismatch burst: the first of those
MOB_RES_STREAMS = 4       # each burst of the residency check
# The swap lane: one prompt in each chunk bucket (8, 16, 32, 64), so each
# prefill runs alone under pressure and unpressured alike, and 64 new
# tokens each; a pool of one full sequence (12 pages) and the trash page,
# which the four streams (24 pages at their ends) outgrow.
MOB_SWAP_PROMPTS = (7, 15, 31, 63)
MOB_SWAP_NEW = 64
MOB_SWAP_BLOCKS = 13
# The two-process migration: its prompt's tokens and the tokens a stream
# streams before it moves.
MOB_MOVE_PROMPT = 40


def mobility_config(arch: dict | None = None, **extra):
    """Phase 17's deployment: ``gpt2`` (GPT-2 small int8, paged, with
    ``spec_draft: gpt2_draft``, k = 4), ``gpt2_plain`` (the same without
    speculation), ``gpt2_draft`` (GPT-2 small from the same seed in bf16:
    a second deploy, so its proposals are mostly accepted) and ``gpt2_swap``
    (the int8 target, ``MOB_SWAP_NEW`` new tokens, on a pool of
    ``MOB_SWAP_BLOCKS`` pages).  No lane has
    the prefix cache: a stream admitted on a hit decodes plain (the draft
    never prefilled the skipped positions), and every burst must prefill
    its prompts as the first did."""
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig

    lane = {"max_new_tokens": MOB["max_new_tokens"], "gen_slots": MOB["gen_slots"],
            "segment_tokens": MOB["segment_tokens"], **({"arch": arch} if arch else {})}
    paged = {"kv_cache": "paged", "kv_block_size": MOB["block_size"],
             "prefill_chunk_tokens": MOB["chunk"]}
    common = {"dtype": "bfloat16", "batch_buckets": (1,), "seq_buckets": MOB["seq_buckets"]}
    int8 = {**lane, "params_dtype": "int8", **extra}
    return ServeConfig(models=[
        ModelConfig(name="gpt2", **common, **paged, spec_draft="gpt2_draft",
                    spec_k=MOB["spec_k"], prefix_cache=False, extra=int8),
        ModelConfig(name="gpt2_plain", builder="gpt2", **common, **paged, prefix_cache=False,
                    extra=int8),
        ModelConfig(name="gpt2_draft", builder="gpt2", **common,
                    extra={**lane, "params_dtype": "bfloat16"}),
        ModelConfig(name="gpt2_swap", builder="gpt2", **common, **paged,
                    kv_num_blocks=MOB_SWAP_BLOCKS, prefix_cache=False,
                    extra={**int8, "max_new_tokens": MOB_SWAP_NEW})])


def mob_bodies(n: int, vocab: int, seed: int = 17, max_prompt: int = 120) -> list[dict]:
    """``n`` requests of ``MOB["max_new_tokens"]`` tokens, prompts of 5 to
    ``max_prompt`` ids, every other one sampled with top-k and top-p."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        body = {"input_ids": rng.integers(0, vocab - 1, int(rng.integers(5, max_prompt + 1)))
                .tolist(), "max_new_tokens": MOB["max_new_tokens"]}
        if i % 2:
            body.update(GEN_SAMPLED, seed=int(rng.integers(0, 1 << 16)))
        out.append(body)
    return out


def phase_mobility_path(cfg, device: str = "cuda", vocab: int = 50257) -> dict:
    """Serve phase 17's deployment and drive it over HTTP: (1) the same
    burst of ``MOB_SPEC_STREAMS`` SSE streams on ``gpt2`` (speculation on)
    and ``gpt2_plain`` (off), one each, then ``MOB_MISMATCH_STREAMS`` of
    them with the ``spec_mismatch`` fault; (2) the swap lane's prompts one at
    a time (unpressured), then all at once (they must swap), then all at
    once with a ``migration`` drop on every swap (they must evict); (3) the
    draft demoted to the host tier and a burst, then the draft restored and
    a burst.  The kernel counts are read just after the load, with the
    lanes' graph runs for the exact count."""
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    t0 = time.perf_counter()
    engine = build_engine(cfg, device)
    log(f"mobility engines ready in {time.perf_counter() - t0:.3f} s on {engine.device}: "
        f"build {engine.build_seconds}")
    out: dict = {"engine": engine}
    bodies = mob_bodies(MOB_SPEC_STREAMS, vocab)
    out["bodies"] = bodies
    rng = np.random.default_rng(23)
    swap_bodies = [{"input_ids": rng.integers(0, vocab - 1, n).tolist(),
                    "max_new_tokens": MOB_SWAP_NEW,
                    **({**GEN_SAMPLED, "seed": 100 + i} if i % 2 else {})}
                   for i, n in enumerate(MOB_SWAP_PROMPTS)]
    out["swap_bodies"] = swap_bodies
    faults = engine.runner.faults
    with BackgroundServer(cfg, engine) as srv:
        scheds = srv.server.schedulers
        spec, swap = scheds["gpt2"], scheds["gpt2_swap"]
        t0 = time.perf_counter()
        engine.runner.run_fn_sync(spec.warm, engine.model("gpt2_draft"))
        out["spec_warm_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        engine.runner.run_fn_sync(scheds["gpt2_plain"].warm)
        engine.runner.run_fn_sync(swap.warm)
        log(f"lanes warmed: gpt2 with its draft's graphs {out['spec_warm_s']:.3f} s, gpt2_plain "
            f"and gpt2_swap {time.perf_counter() - t0:.3f} s; graphs "
            f"{ {n: engine.model(n).graphs for n in ('gpt2', 'gpt2_draft')} }")
        before = {n: s.kernels.graphs.expected_launches() for n, s in scheds.items()}
        reset_counts()
        spec0 = dict(spec.gen_snapshot()["spec"])
        # (1) Speculation on against off, one burst each.
        runs: dict = {"gpt2": [], "gpt2_plain": []}
        for name in ("gpt2", "gpt2_plain"):
            # The first burst on is held tick by tick: its ticks recorded.
            with SpecTicks(spec) as rec:
                res, wall = gen_burst(srv.port, name, bodies)
            if name == "gpt2" and "spec_ticks" not in out:
                out["spec_ticks"] = rec.ticks
            check(all(r["status"] == 200 for r in res),
                  f"{name}: statuses {[r['status'] for r in res]}")
            check_sse(res, vocab)
            runs[name].append((res, wall))
        out["spec_runs"] = runs
        out["spec_stats"] = {k: v - spec0[k] for k, v in spec.gen_snapshot()["spec"].items()
                             if k in ("proposed", "accepted", "fallback_ticks")}
        out["spec_headers"] = [r["headers"].get("X-Spec-Draft") for r in runs["gpt2"][0][0]]
        out["spec_finals"] = [r["final"].get("stats", {}) for r in runs["gpt2"][0][0]]
        # The spec_mismatch fault on every tick: the rejection path.
        spec1 = dict(spec.gen_snapshot()["spec"])
        faults.configure(model="gpt2", fail_every_n=1, kind="spec_mismatch")
        with SpecTicks(spec) as mrec:
            mres, mwall = gen_burst(srv.port, "gpt2", bodies[:MOB_MISMATCH_STREAMS])
        faults.clear("gpt2")
        check(all(r["status"] == 200 for r in mres), "spec_mismatch burst statuses")
        check_sse(mres, vocab)
        out["mismatch"] = {"results": mres, "wall": mwall, "ticks": mrec.ticks,
                           "stats": {k: v - spec1[k] for k, v in spec.gen_snapshot()["spec"]
                                     .items() if k in ("proposed", "accepted", "fallback_ticks")},
                           "injected": faults.snapshot()["injected"]["spec"]}
        # (2) The swap lane: alone over HTTP, then together (submitted in one
        # turn of the loop, so that all four are admitted in one tick and
        # then outgrow the pool), then together with every swap dropped.
        alone = [sse(srv.port, "gpt2_swap", b) for b in swap_bodies]
        snap0 = swap.gen_snapshot()
        t0 = time.perf_counter()
        together = submit_together(srv, swap, engine.model("gpt2_swap"), swap_bodies)
        twall = time.perf_counter() - t0
        snap1 = swap.gen_snapshot()
        faults.configure(model="gpt2_swap", fail_every_n=1, kind="migration", mode="drop")
        dropped = submit_together(srv, swap, engine.model("gpt2_swap"), swap_bodies)
        faults.clear("gpt2_swap")
        snap2 = swap.gen_snapshot()
        out["swap"] = {"alone": alone, "together": together, "wall": twall, "dropped": dropped,
                       "snaps": (snap0, snap1, snap2)}
        # (3) The draft demoted to the host, then restored.
        rbodies = [b for b in bodies if "temperature" not in b][:MOB_RES_STREAMS]
        before_graphs = spec._draft_kernels.graphs
        status, body = http(srv.port, "/admin/models/gpt2_draft",
                            {"action": "demote", "to": "host"})
        check(status == 200, f"draft demotion: {status} {body}")
        res0 = dict(spec.gen_snapshot()["spec"])
        cold, _ = gen_burst(srv.port, "gpt2", rbodies)
        res1 = dict(spec.gen_snapshot()["spec"])
        released = before_graphs.released
        t0 = time.perf_counter()
        status, body = http(srv.port, "/admin/models/gpt2_draft", {"action": "activate"})
        restore_s = time.perf_counter() - t0
        check(status == 200, f"draft restore: {status} {body}")
        back, _ = gen_burst(srv.port, "gpt2", rbodies)
        res2 = dict(spec.gen_snapshot()["spec"])
        after_graphs = spec._draft_kernels.graphs
        out["residency"] = {"cold": cold, "back": back, "snaps": (res0, res1, res2),
                            "released": released, "restore_s": restore_s,
                            "new_set": after_graphs is not before_graphs,
                            "new_released": after_graphs.released,
                            "new_labels": after_graphs.labels,
                            "draft_cm": spec._draft_kernels.cm is engine.model("gpt2_draft")}
        out["counts"] = read_counts()  # just after the load
        out["expected"] = {}
        for n, sched in scheds.items():
            for k, v in sched.kernels.graphs.expected_launches().items():
                out["expected"][k] = out["expected"].get(k, 0) + v - before[n].get(k, 0)
        out["per_run"] = dict(spec.kernels.graphs.per_run)
        status, prom = http_text(srv.port, "/metrics?format=prometheus")
        check(status == 200, f"/metrics?format=prometheus: {status}")
        out["prometheus"] = prom
        out["snapshots"] = {n: s.gen_snapshot() for n, s in scheds.items()}
    return out


def submit_together(srv, sched, cm, bodies: list[dict], timeout: float = 300.0) -> list[dict]:
    """``bodies`` submitted to the lane ``sched`` in one turn of the
    server's loop (what ``:generate`` does for each request), so that they
    admit in one tick, and awaited: each stream's tokens, as ``sse``'s
    results."""
    async def run():
        reqs = [sched.submit(cm.servable.preprocess(b), b.get("max_new_tokens")) for b in bodies]
        return await asyncio.wait_for(asyncio.gather(*(r.done for r in reqs)), timeout)

    return [{"status": 200, "tokens": toks} for toks in srv.call(run, timeout=timeout + 10)]


def http_text(port: int, path: str) -> tuple[int, str]:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return r.status, r.read().decode()


def diverge_undecided(refs: list, err: float, on: list[dict], off: list[dict]) -> dict:
    """Greedy streams with speculation on against off: they agree up to
    their first difference, and there the fixed route's top-2 margin (its
    logits teacher-forced along the ``on`` stream, ``refs``) is within
    twice the lane's logit error; else fail.  Returns the counts."""
    out = {"equal": 0, "parted": [], "tokens": 0}
    for (toks, ref), a, b in zip(refs, on, off):
        x, y = a["tokens"], b["tokens"]
        out["tokens"] += len(x)
        if x == y:
            out["equal"] += 1
            continue
        d = next((i for i, (p, q) in enumerate(zip(x, y)) if p != q), min(len(x), len(y)))
        if d < ref.shape[0]:
            top2 = ref[d].topk(2).values
            margin = float(top2[0] - top2[1])
        else:
            margin = 0.0
        out["parted"].append((a["tag"], d, round(margin, 5)))
        check(margin <= 2 * err, f"{a['tag']}: speculation on and off part at position {d} "
                                 f"where the fixed route's margin {margin:.4g} exceeds twice "
                                 f"the error {err:.4g}")
    return out


def check_mobility(run: dict, vocab: int = 50257, layers: int = 12) -> dict:
    """Phase 17 checks 1, 2 and 4 on the load's answers (check 3 is
    :func:`phase_mobility_move`)."""
    engine = run["engine"]
    max_new = MOB["max_new_tokens"]
    paged = (MOB["chunk"], MOB["block_size"])
    out: dict = {}
    # (1) Speculation: greedy streams under the margin rule at the verify's
    # rows, sampled ones held to the filter; on against off.
    bodies = run["bodies"]
    on, off = run["spec_runs"]["gpt2"], run["spec_runs"]["gpt2_plain"]
    st = run["spec_stats"]
    check(st["proposed"] > 0 and 0 < st["accepted"] <= st["proposed"],
          f"speculation stats {st}")
    check(all(h == "gpt2_draft" for h in run["spec_headers"]),
          f"X-Spec-Draft headers {run['spec_headers']}")
    check(all(f.get("spec_draft") == "gpt2_draft" and f.get("spec_proposed", 0) > 0
              for f in run["spec_finals"]), f"final stats {run['spec_finals'][:2]}")
    streams_on = lane_streams(bodies, on[0][0], max_new, "on")
    streams_off = lane_streams(bodies, off[0][0], max_new, "off")
    greedy = [i for i, b in enumerate(bodies) if "temperature" not in b]
    sampled = [i for i, b in enumerate(bodies) if "temperature" in b]
    held_on = hold_streams(engine, "gpt2", [streams_on[i] for i in greedy], SPEC_M, paged,
                           keep_refs=True)
    check(st["fallback_ticks"] == 0, f"speculation fell back to plain decode on "
                                     f"{st['fallback_ticks']} ticks with the draft resident")
    held_on_s = hold_spec_streams(engine, "gpt2", "gpt2_draft", [streams_on[i] for i in sampled],
                                  run["spec_ticks"], SPEC_M, MOB["gen_slots"], paged,
                                  held_on["err_max"])
    held_off = hold_streams(engine, "gpt2_plain", streams_off, MOB["gen_slots"], paged)
    div = diverge_undecided(held_on["refs"], held_on["err_max"],
                            [streams_on[i] for i in greedy], [streams_off[i] for i in greedy])
    tps = {name: [stream_stats(res, wall)["tok_per_s"] for res, wall in runs]
           for name, runs in run["spec_runs"].items()}
    rate = st["accepted"] / max(st["proposed"], 1)
    log(f"speculation (gpt2 int8 target, gpt2_draft bf16, k={MOB['spec_k']}): {st['proposed']} "
        f"proposed, {st['accepted']} accepted (rate {rate:.4f}), {st['fallback_ticks']} fallback "
        f"ticks over a burst of {len(bodies)} streams; tokens/s on {tps['gpt2']}, off "
        f"{tps['gpt2_plain']}; greedy on == off on {div['equal']} of {len(greedy)} streams, "
        f"parted at undecided positions {div['parted']}")
    # The spec_mismatch burst: every proposal derailed, the same rules.
    mm = run["mismatch"]
    check(mm["injected"] > 0 and mm["stats"]["proposed"] > 0
          and mm["stats"]["fallback_ticks"] == 0, f"spec_mismatch fired nothing: {mm}")
    check(mm["stats"]["accepted"] <= mm["stats"]["proposed"] // 10,
          f"spec_mismatch: {mm['stats']['accepted']} of {mm['stats']['proposed']} derailed "
          "proposals accepted")
    mbodies = bodies[:MOB_MISMATCH_STREAMS]
    mstreams = lane_streams(mbodies, mm["results"], max_new, "mismatch")
    mg = [s for s, b in zip(mstreams, mbodies) if "temperature" not in b]
    ms = [s for s, b in zip(mstreams, mbodies) if "temperature" in b]
    same = sum(s["tokens"] == streams_on[i]["tokens"] for i, s in enumerate(mstreams)
               if "temperature" not in mbodies[i])
    held_mm = hold_streams(engine, "gpt2", mg, SPEC_M, paged, err=held_on["err_max"])
    held_mm_s = hold_spec_streams(engine, "gpt2", "gpt2_draft", ms, mm["ticks"], SPEC_M,
                                  MOB["gen_slots"], paged, held_on["err_max"], mismatch=True)
    log(f"spec_mismatch: {mm['stats']['accepted']} of {mm['stats']['proposed']} proposals "
        f"accepted, {same} of {len(mg)} greedy streams byte-equal to speculation without the "
        f"fault, {mm['injected']} ticks derailed")
    # (2) The swap: pressure swaps, nothing evicted, byte-equal to alone.
    sw = run["swap"]
    s0, s1, s2 = sw["snaps"]
    check(all(r["status"] == 200 for r in sw["alone"] + sw["together"] + sw["dropped"]),
          "swap lane statuses")
    pressure = s1["migration"]["by_cause"]["pressure"] - s0["migration"]["by_cause"]["pressure"]
    check(s0["kv"]["evictions"] == 0 and s0["migration"]["by_cause"]["pressure"] == 0,
          f"the unpressured swap runs moved a stream: {s0['kv']}, {s0['migration']}")
    check(pressure > 0 and s1["kv"]["evictions"] == 0,
          f"the swap lane: {pressure} swaps, {s1['kv']['evictions']} evictions")
    for i, (a, b) in enumerate(zip(sw["alone"], sw["together"])):
        check(a["tokens"] == b["tokens"], f"swap stream {i}: {b['tokens'][:8]}... under pressure "
                                          f"differs from alone {a['tokens'][:8]}...")
    evicted = s2["kv"]["evictions"] - s1["kv"]["evictions"]
    check(evicted > 0 and s2["migration"]["by_cause"]["pressure"] == s1["migration"]["by_cause"][
        "pressure"] and s2["migration"]["failed"] > s1["migration"]["failed"],
          f"the drop rule: {evicted} evictions, {s2['migration']}")
    # An evicted stream re-prefills its prompt and tokens, and the first
    # token after it draws at step 0 again (the JAX package's eviction does
    # the same): a greedy chain continues, a sampled one is held to the
    # filter.
    held_drop = hold_streams(engine, "gpt2_swap",
                             lane_streams(run["swap_bodies"], sw["dropped"], MOB_SWAP_NEW,
                                          "drop"),
                             MOB["gen_slots"], paged, support=True)
    ms_hist = s1["migration"]["ms"]
    log(f"swap lane ({MOB_SWAP_BLOCKS - 1} pages of {MOB['block_size']}, 4 streams): {pressure} "
        f"swaps to host, 0 evictions, all 4 byte-equal to the same streams alone, "
        f"{s1['migration']['pages']['copied'] - s0['migration']['pages']['copied']} pages moved, "
        f"swap ms histogram {ms_hist['buckets']} (sum {ms_hist['sum']:.3f}); with the drop "
        f"rule {evicted} evictions and every stream finished")
    # (4) Residency: the draft demoted, then restored.
    rs = run["residency"]
    r0, r1, r2 = rs["snaps"]
    check(all(r["status"] == 200 and r["final"] and r["final"].get("done")
              for r in rs["cold"] + rs["back"]), "residency bursts")
    check(rs["released"] and r1["proposed"] == r0["proposed"]
          and r1["fallback_ticks"] > r0["fallback_ticks"]
          and all("X-Spec-Draft" not in r["headers"] for r in rs["cold"]),
          f"with the draft demoted: {r0} -> {r1}, released {rs['released']}")
    check(rs["new_set"] and not rs["new_released"] and rs["draft_cm"]
          and r2["proposed"] > r1["proposed"]
          and (engine.device.type != "cuda"  # the CPU captures nothing
               or any(lbl.startswith("generate propose") for lbl in rs["new_labels"]))
          and all(r["headers"].get("X-Spec-Draft") == "gpt2_draft" for r in rs["back"]),
          f"after the restore: {r1} -> {r2}, labels {rs['new_labels']}")
    log(f"residency: the draft demoted to host, {len(rs['cold'])} streams decoded plain "
        f"({r1['fallback_ticks'] - r0['fallback_ticks']} fallback ticks, no error); restored in "
        f"{rs['restore_s']:.3f} s, its graphs captured again ({rs['new_labels']}) and "
        f"speculation back ({r2['proposed'] - r1['proposed']} proposed)")
    # Counts: exact against the lanes' graph runs; the verify's products.
    exact_counts(run["counts"], run["expected"], "the mobility load")
    if engine.device.type == "cuda":
        ver = {k: v for k, v in run["per_run"].items() if k[0] == "verify"}
        check(ver and all(v.get("int8_matmul") == 4 * layers + 1 for v in ver.values()),
              f"int8_matmul launches a verify {ver}")
    cmt = check_metrics_tool()
    problems = cmt.check(run["prometheus"], cmt.load_manifest())
    check(not problems, f"/metrics against the manifest: {problems}")
    for fam in ("tpuserve_migrations_total", "tpuserve_migration_pages_total",
                "tpuserve_migration_ms", "tpuserve_spec_proposed_total",
                "tpuserve_spec_accepted_total"):
        check(fam in run["prometheus"], f"{fam} missing from /metrics")
    out.update(held={"on": held_on, "on_sampled": held_on_s, "off": held_off,
                     "mismatch": held_mm, "mismatch_sampled": held_mm_s, "drop": held_drop},
               rate=rate, tok_per_s=tps, diverge=div, swaps=pressure)
    for h in out["held"].values():
        h.pop("refs", None)
    return out


def phase_mobility_move(card: str, workdir: str, engine, platform: str = "cuda",
                        model: dict | None = None) -> dict:
    """Phase 17 check 3: live migration between two ``cli serve`` processes
    on the card, each with GPT-2 small int8 on the paged lane
    (``tools/streammove.py``): a stream moved mid-decode to a target that
    never saw its prompt is byte-equal to the source's control; the same
    prompt moved again dedupes its prompt pages against the target's tree
    (held under the margin rule where it is not byte-equal); a corrupt page
    is caught by the importer and fetched again; a drop answers 503 with
    Retry-After, and an abort resumes the stream in place.  No token is
    lost or repeated: the source streams up to the watermark and ends with
    the migrated event, the attach streams the rest."""
    from pytorch_zappa_serverless_tpu_torch.tools import streammove

    t0 = time.perf_counter()
    model = model or streammove.MODEL
    out = streammove.run_streammove(workdir, platform, model, prompt_len=MOB_MOVE_PROMPT)
    ctl = out["control"]
    for case in ("fresh", "dedup", "corrupt"):
        c = out[case]
        check(c["source_end"] and c["source_end"].get("migrated") is True
              and c["source_end"]["watermark"] == c["watermark"] == len(c["source_tokens"]),
              f"{case}: the source's end {c['source_end']}, watermark {c['watermark']}, "
              f"{len(c['source_tokens'])} tokens streamed")
        check(c["attach_end"] and c["attach_end"].get("done") is True
              and c["attach_end"]["tokens"] == c["tokens"],
              f"{case}: the attach's end {c['attach_end']} does not close the tokens")
        check(len(c["tokens"]) == len(ctl[case]), f"{case}: {len(c['tokens'])} tokens, the "
                                                  f"control {len(ctl[case])}: lost or repeated")
    check(out["fresh"]["dedup_pages"] == 0 and out["fresh"]["tokens"] == ctl["fresh"],
          f"fresh: {out['fresh']['dedup_pages']} pages deduped, tokens equal "
          f"{out['fresh']['tokens'] == ctl['fresh']}")
    check(out["dedup"]["dedup_pages"] >= 1, f"dedup: {out['dedup']['dedup_pages']} pages deduped")
    dedup_equal = out["dedup"]["tokens"] == ctl["dedup"]
    if not dedup_equal:
        hold_streams(engine, "gpt2_plain", [{
            "tag": "dedup", "ids": out["bodies"]["dedup"]["input_ids"],
            "tokens": out["dedup"]["tokens"],
            "ended": len(out["dedup"]["tokens"]) < model["extra"]["max_new_tokens"],
            "knobs": {}}], MOB["gen_slots"], (MOB["chunk"], MOB["block_size"]))
    check(out["corrupt"]["attempts"] == 2 and out["corrupt"]["tokens"] == ctl["corrupt"],
          f"corrupt: {out['corrupt']['attempts']} import attempts, tokens equal "
          f"{out['corrupt']['tokens'] == ctl['corrupt']}")
    d = out["drop"]
    check(d["status"] == 503 and int(d["retry_after"]) >= 1 and d["body"].get("retryable")
          is True, f"drop: {d['status']} Retry-After {d['retry_after']} {d['body']}")
    check(d["cutover"] == 200 and d["abort"] == 200 and d["tokens"] == ctl["drop"]
          and d["end"] and d["end"].get("done"), f"abort: {d['cutover']} {d['abort']}, tokens "
                                                  f"equal {d['tokens'] == ctl['drop']}")
    src, dst = out["source"], out["target"]
    check(dst["migration"]["by_cause"]["admin"] == 3 and src["migration"]["by_cause"]["admin"]
          == 3, f"migrations: source {src['migration']['by_cause']}, target "
                f"{dst['migration']['by_cause']}")
    out["int8_launches"] = (src["kernels"].get("int8_matmul", 0)
                            + dst["kernels"].get("int8_matmul", 0))
    out["seconds"] = time.perf_counter() - t0
    ms = dst["migration"]["ms"]
    log(f"{card}: two-process migration (GPT-2 small int8, a {MOB_MOVE_PROMPT}-token prompt, "
        f"{model['extra']['max_new_tokens']} new tokens): boots {out['boot_s']} s; "
        + "; ".join(f"{c}: moved after {len(out[c]['source_tokens'])} tokens, "
                    f"{out[c]['dedup_pages']} pages deduped and {out[c]['copied_pages']} copied "
                    f"of {out[c]['npages']} ({out[c]['snapshot_pages']} at the snapshot, "
                    f"{out[c]['cutover_pages']} at the cutover), {out[c]['attempts']} import "
                    f"attempts, {out[c]['move_ms']:.3f} ms cutover to commit, byte-equal "
                    f"{out[c]['tokens'] == ctl[c]}" for c in ("fresh", "dedup", "corrupt"))
        + f"; drop 503 Retry-After {d['retry_after']}, the abort resumed in place; the "
          f"target's import ms histogram {ms['buckets']} (sum {ms['sum']:.3f}), pages "
          f"{dst['migration']['pages']}; int8_matmul launches {out['int8_launches']} in the two "
          f"processes; {out['seconds']:.3f} s")
    return out


def run_mobility(card: str) -> dict:
    """Phase 17: stream mobility and speculation on the paged lane."""
    import tempfile

    fresh_memory()
    t0 = time.perf_counter()
    run = phase_mobility_path(mobility_config())
    engine = run["engine"]
    try:
        log_memory("mobility", engine)
        checked = check_mobility(run)
        check(run["counts"]["flash_attention"] == 0, f"flash on the mobility path: "
                                                     f"{run['counts']}")
        with tempfile.TemporaryDirectory(prefix="tpuserve-move-") as tmp:
            move = phase_mobility_move(card, tmp, engine)
    finally:
        engine.shutdown()
    launches = run["counts"]["int8_matmul"] + move["int8_launches"]
    log(f"{card}: stream mobility and speculation (phase 17) in "
        f"{time.perf_counter() - t0:.3f} s; int8_matmul launches {launches} "
        f"({run['counts']['int8_matmul']} in process, {move['int8_launches']} in the two "
        f"servers)")
    return {"int8_launches": launches, "checked": checked, "move": move}


# -- phase 18: multi-tenant adapters and the regime-routed lane --------------

# GPT-2 small bf16 with a stack pool of 4 slots at rank 8 on q and v, three
# tenants from seeds; its :predict buckets and its paged lane.
LORA = {"seq_buckets": (64,), "batch_buckets": (1, 4, 8), "max_new_tokens": 24,
        "gen_slots": 8, "segment_tokens": 8, "block_size": 16, "chunk": 64, "slots": 4,
        "rank": 8}
LORA_TENANTS = ("t1", "t2", "t3")
# Tried in turn: the smallest at which each seeded tenant's greedy tokens
# part from the base's on the probe prompt (random rank-8 factors of 0.05
# move GPT-2 small's near-flat seeded logits only at a large scale).
LORA_ALPHAS = (16.0, 64.0, 256.0, 1024.0, 4096.0)
LORA_PROMPT = 12
LORA_CYCLES = 3
LORA_LEAK_BYTES = 1 << 20
# The regime-routed lane: int8 decode at up to 4 rows (its buckets 1 and 4,
# and its paged lane's 4 slots), bf16 at 8.
AUTO = {"crossover": 4, "gen_slots": 4, "streams": 4, "batch_buckets": (1, 4, 8)}
AUTO_BYTES_TOL = 1 << 20


def lora_config(arch: dict | None = None, alpha: float = LORA_ALPHAS[0]):
    """Phase 18a's deployment: ``gpt2`` (GPT-2 small bf16 with
    ``adapter_slots`` 4, rank 8 on q and v, three tenants from seeds 1-3, the
    paged lane) and ``gpt2_base`` (the same seed with no adapter pool)."""
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig

    lane = {"max_new_tokens": LORA["max_new_tokens"], "gen_slots": LORA["gen_slots"],
            "segment_tokens": LORA["segment_tokens"], **({"arch": arch} if arch else {})}
    common = {"dtype": "bfloat16", "batch_buckets": LORA["batch_buckets"],
              "seq_buckets": LORA["seq_buckets"], "coalesce_ms": 100.0}
    adapters = {t: {"seed": i + 1, "alpha": alpha} for i, t in enumerate(LORA_TENANTS)}
    return ServeConfig(models=[
        ModelConfig(name="gpt2", **common, kv_cache="paged", kv_block_size=LORA["block_size"],
                    prefill_chunk_tokens=LORA["chunk"], adapter_slots=LORA["slots"],
                    adapter_rank=LORA["rank"], adapter_targets=("q", "v"), adapters=adapters,
                    extra=lane),
        ModelConfig(name="gpt2_base", builder="gpt2", **common, extra=lane)])


def auto_config(arch: dict | None = None, **extra):
    """Phase 18b's deployment: ``gpt2_auto`` (``params_dtype: auto``,
    ``int8_crossover_batch`` 4, a paged lane of 4 slots), ``gpt2_int8`` and
    ``gpt2_bf16`` (the same seed on the int8 lane and with bf16 weights at
    rest), each at :predict buckets (1, 4, 8) x 64."""
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig

    lane = {"max_new_tokens": LORA["max_new_tokens"], "gen_slots": AUTO["gen_slots"],
            "segment_tokens": LORA["segment_tokens"], **({"arch": arch} if arch else {}),
            **extra}
    common = {"dtype": "bfloat16", "batch_buckets": AUTO["batch_buckets"],
              "seq_buckets": LORA["seq_buckets"]}
    return ServeConfig(models=[
        ModelConfig(name="gpt2_auto", builder="gpt2", **common, kv_cache="paged",
                    kv_block_size=LORA["block_size"], prefill_chunk_tokens=LORA["chunk"],
                    extra={**lane, "params_dtype": "auto",
                           "int8_crossover_batch": AUTO["crossover"]}),
        ModelConfig(name="gpt2_int8", builder="gpt2", **common,
                    extra={**lane, "params_dtype": "int8"}),
        ModelConfig(name="gpt2_bf16", builder="gpt2", **common,
                    extra={**lane, "params_dtype": "bfloat16"})])


def gpt2_batch_of(cm, payloads: list[dict], slots=None) -> dict:
    """The collated bucket batch of ``payloads`` (each at adapter slot
    ``slots[i]`` where given): what the batcher hands ``forward``."""
    samples = [cm.servable.preprocess(p) for p in payloads]
    if slots is not None:
        for s, a in zip(samples, slots):
            s["adapter_idx"] = np.int32(a)
    seq = max(cm.servable.meta["seq_len_of"](s) for s in samples)
    bucket = cm.bucket_for(len(samples), seq)
    return cm.servable.meta["collate"](samples, bucket, cm.servable.input_spec(bucket))


def row_tokens(cm, out: dict, i: int) -> list[int]:
    return cm.servable.postprocess(out, i)["tokens"]


def lora_pick_alpha(engine, ids: list[int]) -> tuple[float, dict]:
    """The smallest of ``LORA_ALPHAS`` at which each tenant's greedy tokens
    on ``ids`` part from the base's, tried on the dispatch thread: the three
    seeded adapters written into the stacks at that scaling, the bucket-1
    generate run eagerly, and the stacks zeroed again.  Returns (alpha,
    {tenant or "base": tokens at it})."""
    from pytorch_zappa_serverless_tpu_torch.engine import weights as W
    from pytorch_zappa_serverless_tpu_torch.ops import lora as L

    cm = engine.model("gpt2")
    meta = cm.servable.meta["adapters"]

    def toks(slot):
        with torch.inference_mode():
            return row_tokens(cm, cm.forward_eager(gpt2_batch_of(cm, [{"input_ids": ids}],
                                                                 [slot])), 0)

    def run():
        stacks = cm.servable.module.tree()["__adapters__"]
        host = {f"layer{i}": L.zero_stacks(meta["slots"], meta["rank"], meta["dims"])
                for i in range(meta["layers"])}
        trees = [W.init_lora(meta["layers"], meta["dims"], meta["rank"], seed=i + 1)
                 for i in range(len(LORA_TENANTS))]
        base, got = toks(0), {}
        for alpha in LORA_ALPHAS:
            for i, tree in enumerate(trees):
                L.install_adapter(host, i + 1, tree, scaling=alpha / meta["rank"])
                L.write_slot(stacks, host, i + 1)
            got = {t: toks(i + 1) for i, t in enumerate(LORA_TENANTS)}
            if all(got[t] != base for t in LORA_TENANTS):
                break
        for i in range(len(trees)):
            L.clear_slot(host, i + 1)
            L.write_slot(stacks, host, i + 1)
        return alpha, {"base": base, **got}

    alpha, got = engine.runner.run_fn_sync(run)
    check(all(got[t] != got["base"] for t in LORA_TENANTS),
          f"no alpha in {LORA_ALPHAS} parts every tenant from the base: {got}")
    return alpha, got


def replay_device_ms(engine, cm, bucket: tuple) -> float:
    """Device ms of one replay of ``cm``'s captured graph of ``bucket`` (its
    static inputs as the last dispatch left them), queued behind a spin
    kernel (``device_ms``), on the dispatch thread."""
    graph = next(g for k, g in cm._graphs.items() if k[0] == bucket)
    return engine.runner.run_fn_sync(lambda: device_ms(lambda: graph.captured.graph.replay()))


def phase_lora_path(cfg, device: str = "cuda", vocab: int = 50257) -> dict:
    """Phase 18a: serve ``gpt2`` with three seeded tenants and ``gpt2_base``
    and drive them over HTTP: each tenant and the base alone at bucket 1; a
    burst of three tenants and the base in one coalescing window; 8 SSE
    streams on the paged lane (two a tenant, two base) and a burst each of
    adapter and base streams for their rates; three detach and re-attach
    cycles of ``t1`` (a deadline below the estimate on the first); an
    ``adapter`` fault on ``t2``; ``/metrics``.  The kernel counts are read
    just after the requests."""
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    t0 = time.perf_counter()
    engine = build_engine(cfg, device)
    log(f"adapter engines ready in {time.perf_counter() - t0:.3f} s on {engine.device}: "
        f"build {engine.build_seconds}")
    rng = np.random.default_rng(31)
    ids = rng.integers(0, vocab - 1, LORA_PROMPT).tolist()
    alpha, probe = lora_pick_alpha(engine, ids)
    for spec in cfg.models[0].adapters.values():
        spec["alpha"] = alpha
    log(f"adapters: alpha {alpha} (scaling {alpha / LORA['rank']}) parts every tenant's greedy "
        f"tokens from the base's on a {LORA_PROMPT}-token probe: "
        + "; ".join(f"{k} {v[:8]}" for k, v in probe.items()))
    out: dict = {"engine": engine, "alpha": alpha, "ids": ids}
    cm, bcm = engine.model("gpt2"), engine.model("gpt2_base")
    run = engine.runner.run_fn_sync
    max_new = LORA["max_new_tokens"]

    def predict(port, body, name=None, headers=None):
        return http_h(port, "/v1/models/gpt2:predict", body,
                      {**({"X-Adapter": name} if name else {}), **(headers or {})})

    with BackgroundServer(cfg, engine) as srv:
        port, server = srv.port, srv.server
        # The paged lane's graphs captured ahead of traffic, so that no
        # burst below pays a capture.
        run(server.schedulers["gpt2"].warm)
        reset_counts()
        # Each tenant and the base alone at bucket 1 (the attaches).
        solo = {}
        for name in ("base", *LORA_TENANTS):
            st, body, heads = predict(port, {"input_ids": ids}, None if name == "base" else name)
            check(st == 200 and heads.get("X-Adapter") == (None if name == "base" else name),
                  f"{name} alone: {st} {body} {heads.get('X-Adapter')}")
            solo[name] = body["predictions"]["tokens"]
        check(solo == probe, f"served solo tokens {solo} != the eager probe's {probe}")
        _, snap, _ = http_h(port, "/admin/adapters")
        recs = snap["models"]["gpt2"]
        slots = {t: recs[t]["slot"] for t in LORA_TENANTS}
        out["attach_ms"] = {t: recs[t]["last_attach_ms"] for t in LORA_TENANTS}
        # (1) The burst: three tenants and the base in one window.
        names = ("base", *LORA_TENANTS)
        prompts = {n: rng.integers(0, vocab - 1, k).tolist() for n, k in zip(names, (9, 17, 25, 33))}
        multi0 = server.adapters.multi_adapter_batches
        with ThreadPoolExecutor(len(names)) as ex:
            res = dict(zip(names, ex.map(lambda n: predict(port, {"input_ids": prompts[n]},
                                                           None if n == "base" else n), names)))
        for n, (st, body, _) in res.items():
            check(st == 200 and body["timing"]["batch_size"] == 4,
                  f"burst {n}: {st} {body.get('timing')}")
        burst = {n: res[n][1]["predictions"]["tokens"] for n in names}
        out["multi_adapter_batches"] = server.adapters.multi_adapter_batches - multi0
        check(out["multi_adapter_batches"] >= 1, "the burst co-batched no two adapters")
        # The same prompts alone, at bucket 1: the margin rule holds the
        # burst to them (check_lora); how many are byte-equal is printed.
        alone = {n: predict(port, {"input_ids": prompts[n]},
                            None if n == "base" else n)[1]["predictions"]["tokens"]
                 for n in names}
        # (2) 8 SSE streams on the paged lane: two a tenant, two base.
        tags = ("t1", "t1", "t2", "t2", "t3", "t3", None, None)
        bodies = [{"input_ids": rng.integers(0, vocab - 1, int(rng.integers(5, 61))).tolist(),
                   "max_new_tokens": max_new} for _ in tags]
        heads = [{"X-Adapter": t} if t else None for t in tags]
        sres, swall = gen_burst(port, "gpt2", bodies, heads)
        check(all(r["status"] == 200 for r in sres), f"streams: {[r['status'] for r in sres]}")
        check(all(r["headers"].get("X-Adapter") == t for r, t in zip(sres, tags)),
              f"stream X-Adapter headers {[r['headers'].get('X-Adapter') for r in sres]}")
        check_sse(sres, vocab)
        streams = lane_streams(bodies, sres, max_new, "lora")
        for s, t in zip(streams, tags):
            s["aidx"] = slots[t] if t else 0
        out["streams"] = streams
        # Rates: bursts of 8 adapter streams and of 8 base streams, in turn,
        # twice.
        rates: dict = {"adapter": [], "base": []}
        for kind in ("adapter", "base", "adapter", "base"):
            hs = ([{"X-Adapter": LORA_TENANTS[i % 3]} for i in range(8)]
                  if kind == "adapter" else None)
            rb = [{"input_ids": rng.integers(0, vocab - 1, 32).tolist(),
                   "max_new_tokens": max_new} for _ in range(8)]
            rr, rw = gen_burst(port, "gpt2", rb, hs)
            check(all(r["status"] == 200 for r in rr), f"{kind} rate burst statuses")
            rates[kind].append(stream_stats(rr, rw))
        out["rates"] = rates
        out["counts"] = read_counts()  # just after the served load
        # (3) Detach and re-attach t1, three times.
        captures, labels = cm.captures, sorted(cm.graphs)
        t1_batch = gpt2_batch_of(cm, [{"input_ids": ids}], [slots["t1"]])
        base_batch = gpt2_batch_of(cm, [{"input_ids": ids}], [0])
        base_bytes = run(cm.forward, base_batch)["tokens"]
        mem0 = 0
        if cm.device.type == "cuda":
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
        cycles = []
        for c in range(LORA_CYCLES):
            st, body, _ = http_h(port, "/admin/adapters/gpt2/t1", {"action": "detach"})
            check(st == 200 and body["adapter"]["state"] == "cold", f"detach {c}: {st} {body}")
            check(same_bits(run(cm.forward, t1_batch)["tokens"], base_bytes),
                  f"cycle {c}: the detached slot {slots['t1']} does not replay the base's bytes")
            row = {}
            if c == 0:
                # A deadline below the attach estimate: 503 adapter_cold, no dispatch.
                batches = engine.runner.stats["gpt2"].batches
                reset_counts()
                st, body, hd = predict(port, {"input_ids": ids}, "t1", {"X-Deadline-Ms": "0.01"})
                check(st == 503 and body.get("adapter_cold") is True
                      and int(hd.get("Retry-After", 0)) >= 1,
                      f"the cold request: {st} {body} Retry-After {hd.get('Retry-After')}")
                check(engine.runner.stats["gpt2"].batches == batches
                      and not any(read_counts().values()),
                      f"the cold request dispatched: {read_counts()}")
                row["cold"] = {"status": st, "estimated_attach_ms": body["estimated_attach_ms"],
                               "retry_after": hd["Retry-After"]}
                wait_until(lambda: http_h(port, "/admin/adapters")[1]["models"]["gpt2"]["t1"]
                           ["state"] == "active", 60, "t1's background attach")
            else:
                st, body, _ = http_h(port, "/admin/adapters/gpt2/t1", {"action": "attach"})
                check(st == 200 and body["adapter"]["state"] == "active", f"attach {c}: {body}")
            st, body, _ = predict(port, {"input_ids": ids}, "t1")
            check(st == 200 and body["predictions"]["tokens"] == solo["t1"],
                  f"cycle {c}: t1 after the re-attach {body} != {solo['t1']}")
            _, snap, _ = http_h(port, "/admin/adapters")
            check(snap["models"]["gpt2"]["t1"]["slot"] == slots["t1"],
                  f"cycle {c}: t1 came back at slot {snap['models']['gpt2']['t1']['slot']}")
            if cm.device.type == "cuda":
                torch.cuda.synchronize()
                row["mem_delta"] = torch.cuda.memory_allocated() - mem0
                check(abs(row["mem_delta"]) <= LORA_LEAK_BYTES,
                      f"cycle {c}: memory_allocated moved {row['mem_delta']} bytes")
            row["attach_ms"] = snap["models"]["gpt2"]["t1"]["last_attach_ms"]
            cycles.append(row)
        check(cm.captures == captures and sorted(cm.graphs) == labels,
              f"the cycles captured graphs: {captures} -> {cm.captures}, "
              f"{sorted(set(cm.graphs) - set(labels))}")
        out["cycles"] = cycles
        # (4) An adapter fault poisons t2's attach.
        st, body, _ = http_h(port, "/admin/adapters/gpt2/t2", {"action": "detach"})
        check(st == 200, f"detach t2: {st} {body}")
        st, body, _ = http_h(port, "/admin/faults", {"model": "gpt2:t2", "fail_every_n": 1,
                                                     "kind": "adapter"})
        check(st == 200, f"the adapter rule: {st} {body}")
        st, body, hd = predict(port, {"input_ids": ids}, "t2")
        check(st == 503 and body.get("adapter_attach_failed") and "Retry-After" in hd,
              f"the poisoned tenant: {st} {body}")
        for name in ("base", "t1", "t3"):
            st, body, _ = predict(port, {"input_ids": ids}, None if name == "base" else name)
            check(st == 200 and body["predictions"]["tokens"] == solo[name],
                  f"{name} beside the poisoned tenant: {st} {body}")
        st, body, _ = http_h(port, "/admin/faults", {"clear": True, "model": "gpt2:t2"})
        check(st == 200, f"clearing the rule: {st} {body}")
        st, body, _ = predict(port, {"input_ids": ids}, "t2")
        check(st == 200 and body["predictions"]["tokens"] == solo["t2"], f"t2 healed: {body}")
        # (5) The adapter families through the manifest.
        status, prom = http_text(port, "/metrics?format=prometheus")
        check(status == 200, f"/metrics?format=prometheus: {status}")
        out["prometheus"] = prom
        _, snap, _ = http_h(port, "/admin/adapters")
        out["snapshot"] = snap
    # Off the server: the burst's rows against their masked runs and the
    # adapter-free model, in the same bucket, on the dispatch thread.
    order = ("base", *LORA_TENANTS)
    slot_of = {"base": 0, **slots}
    rows = [{"input_ids": prompts[n]} for n in order]
    masked = {}
    for i, n in enumerate(order):
        keep = [slot_of[m] if j == i else 0 for j, m in enumerate(order)]
        masked[n] = row_tokens(cm, run(cm.forward, gpt2_batch_of(cm, rows, keep)), i)
    plain = row_tokens(bcm, run(bcm.forward, gpt2_batch_of(bcm, rows)), 0)
    out["burst"] = {"tokens": burst, "masked": masked, "plain": plain, "prompts": prompts,
                    "slots": slot_of, "alone": alone}
    # The LoRA delta's cost: bucket 4 replayed on gpt2 (the mixed batch in
    # its static inputs) and on gpt2_base.
    if cm.device.type == "cuda":
        run(cm.forward, gpt2_batch_of(cm, rows, [slot_of[n] for n in order]))
        run(bcm.forward, gpt2_batch_of(bcm, rows))
        out["replay_ms"] = {"adapters": replay_device_ms(engine, cm, (4, 64)),
                            "base": replay_device_ms(engine, bcm, (4, 64))}
    return out


def check_lora(run: dict, vocab: int = 50257, layers: int = 12) -> dict:
    """Phase 18a's checks on the path's results: the burst's rows, byte for
    byte, against their masked runs and the adapter-free model in the same
    bucket, and under the margin rule against each one alone at bucket 1;
    the 8 streams under the margin rule against the fixed route with their
    adapter; no kernel of the port on the bf16 lane; ``/metrics`` against
    the manifest with the adapter families."""
    engine, b = run["engine"], run["burst"]
    for n in LORA_TENANTS:
        check(b["tokens"][n] == b["masked"][n],
              f"burst {n}: {b['tokens'][n]} != its masked run {b['masked'][n]}")
    check(b["tokens"]["base"] == b["masked"]["base"] == b["plain"],
          f"burst base: {b['tokens']['base']}, masked {b['masked']['base']}, adapter-free "
          f"{b['plain']}")
    max_new = LORA["max_new_tokens"]
    held_burst = hold_streams(engine, "gpt2", [
        {"tag": f"burst-{n}", "ids": b["prompts"][n], "tokens": b["tokens"][n],
         "ended": len(b["tokens"][n]) < max_new, "aidx": b["slots"][n]}
        for n in ("base", *LORA_TENANTS)], 4)
    held_streams = hold_streams(engine, "gpt2", run["streams"], LORA["gen_slots"],
                                (LORA["chunk"], LORA["block_size"]))
    check(not any(run["counts"].values()), f"a port kernel on the bf16 adapter lane: "
                                           f"{run['counts']}")
    cmt = check_metrics_tool()
    problems = cmt.check(run["prometheus"], cmt.load_manifest())
    check(not problems, f"/metrics against the manifest: {problems}")
    for fam in ("tpuserve_adapter_residency", "tpuserve_adapter_served_total",
                "tpuserve_adapter_cold_fast_fails_total", "tpuserve_adapter_multi_batches_total",
                "tpuserve_adapter_attach_ms"):
        check(fam in run["prometheus"], f"{fam} missing from /metrics")
    return {"burst": held_burst, "streams": held_streams}


def phase_auto_path(cfg, device: str = "cuda", vocab: int = 50257,
                    profile: bool = False) -> dict:
    """Phase 18b: serve ``gpt2_auto``, ``gpt2_int8`` and ``gpt2_bf16`` and
    drive the routed lane over HTTP (two requests at bucket 1, four
    instances at bucket 4, eight at bucket 8, and ``AUTO["streams"]`` SSE
    streams on its paged lane), the kernel counts read just after; then,
    on the dispatch thread, each bucket's replay against its reference,
    the poison, the device bytes and the timings; with ``profile``, one
    replayed bucket-1 call of ``gpt2_auto``, ``gpt2_int8`` and ``gpt2_bf16``
    under ``torch.profiler`` (device time by kernel)."""
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
    from pytorch_zappa_serverless_tpu_torch.models import gpt2 as G
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    t0 = time.perf_counter()
    engine = build_engine(cfg, device)
    log(f"auto engines ready in {time.perf_counter() - t0:.3f} s on {engine.device}: "
        f"build {engine.build_seconds}")
    cm = engine.model("gpt2_auto")
    meta = cm.servable.meta
    layers, max_new = meta["config"].layers, LORA["max_new_tokens"]
    per_call = (4 * layers + 1) * max_new  # a generate call below the crossover
    rng = np.random.default_rng(37)
    payloads = [{"input_ids": rng.integers(0, vocab - 1, int(k)).tolist()}
                for k in rng.integers(5, 61, 8)]
    out: dict = {"engine": engine, "per_call": per_call}
    run = engine.runner.run_fn_sync
    with BackgroundServer(cfg, engine) as srv:
        port = srv.port
        sched = srv.server.schedulers["gpt2_auto"]
        run(sched.warm)  # the lane's graphs captured ahead of traffic
        before = sched.kernels.graphs.expected_launches()
        reset_counts()
        served = []
        for body in ([payloads[0]], [payloads[1]], payloads[:4], payloads):
            st, ans, _ = http_h(port, "/v1/models/gpt2_auto:predict",
                                body[0] if len(body) == 1 else {"instances": body})
            check(st == 200, f"auto :predict of {len(body)}: {st} {ans}")
            served.append((len(body), ans))
        bodies = [{"input_ids": rng.integers(0, vocab - 1, int(rng.integers(5, 61))).tolist(),
                   "max_new_tokens": max_new} for _ in range(AUTO["streams"])]
        sres, swall = gen_burst(port, "gpt2_auto", bodies)
        check(all(r["status"] == 200 for r in sres), f"auto streams {[r['status'] for r in sres]}")
        check_sse(sres, vocab)
        out["counts"] = read_counts()  # just after the served load
        lane = {k: v - before.get(k, 0)
                for k, v in sched.kernels.graphs.expected_launches().items()}
        out["expected"] = {k: lane.get(k, 0) + (3 * per_call if k == "int8_matmul" else 0)
                           for k in set(lane) | {"int8_matmul"}}
        out["streams"] = lane_streams(bodies, sres, max_new, "auto")
        out["rate"] = stream_stats(sres, swall)
        out["served"] = served
        status, prom = http_text(port, "/metrics?format=prometheus")
        check(status == 200, f"/metrics?format=prometheus: {status}")
        out["prometheus"] = prom
    # Off the server, on the dispatch thread.
    batches = {b: gpt2_batch_of(cm, payloads[:b]) for b in AUTO["batch_buckets"]}
    replays = {}
    for b, batch in batches.items():
        reset_counts()
        replays[b] = run(cm.forward, batch)
        out.setdefault("replay_counts", {})[b] = read_counts()["int8_matmul"]
    bf16 = engine.model("gpt2_bf16")
    out["bf16_8"] = run(bf16.forward, gpt2_batch_of(bf16, payloads))

    def composed(batch):
        tree, cfg_, dtype = cm.servable.module.tree(), meta["config"], meta["dtype"]
        inp = cm._place(batch)
        with torch.inference_mode():
            return G.generate(tree["bf16"], inp["input_ids"], inp["length"], inp["temperature"],
                              inp["seed"], max_new, cfg_, dtype, top_k=inp["top_k"],
                              top_p=inp["top_p"], repetition_penalty=inp["repetition_penalty"],
                              gates=meta["variant_of"](batch),
                              decode_params=G.int8_view(tree, cfg_.layers)).cpu().numpy()

    out["composed"] = {b: run(composed, batches[b]) for b in (1, 4)}
    out["replays"] = replays
    # The poison, in place under the captured graphs: the int8 tree's lm
    # head scales zeroed, then restored.
    scale = cm.servable.module.tree()["int8"]["lm_scale"]
    keep = run(lambda: scale.clone())
    run(lambda: scale.zero_())
    out["poisoned"] = {b: run(cm.forward, batch)["tokens"] for b, batch in batches.items()}
    run(lambda: scale.copy_(keep))
    out["restored"] = {b: run(cm.forward, batch)["tokens"] for b, batch in batches.items()}
    # Device bytes: the routed lane's against the int8 lane's, and one
    # address a tensor.
    i8 = engine.model("gpt2_int8")
    tree = cm.servable.module.tree()
    out["bytes"] = {"auto": cm.param_nbytes(), "int8": i8.param_nbytes(),
                    "bf16_layers": sum(t.numel() * t.element_size() for i in range(layers)
                                       for p in ("q", "k", "v", "out", "fc1", "fc2")
                                       for t in tree["bf16"][f"layer{i}"][p].values()),
                    "addresses": len({t.data_ptr() for t in cm.servable.module.buffers()}),
                    "tensors": len(list(cm.servable.module.buffers()))}
    if cm.device.type == "cuda":
        out["call_ms"] = {(n, b): replay_device_ms(engine, engine.model(n), (b, 64))
                          for n in ("gpt2_auto", "gpt2_int8", "gpt2_bf16")
                          for b in AUTO["batch_buckets"]}
    if profile:
        from pytorch_zappa_serverless_tpu_torch.tools import bench_fused_decode as BF

        for n in ("gpt2_auto", "gpt2_int8", "gpt2_bf16"):
            m = engine.model(n)
            batch = gpt2_batch_of(m, payloads[:1])
            p = run(BF.profile, lambda m=m, batch=batch: m.forward(batch), 1)
            log(f"profile {n} (1, 64) replay: device busy {p['busy_ms']:.4f} ms, wall "
                f"{p['wall_ms_untraced']:.4f} ms untraced")
            for kname, count, ms in p["top"][:12]:
                log(f"profile {n} (1, 64) replay: {ms:9.4f} ms x{count:<6.4g} {kname[:90]}")
    return out


def check_auto(run: dict, layers: int = 12, d_model: int = 768, ffn: int = 3072) -> dict:
    """Phase 18b's checks: bucket 8 the bf16 model's bytes with no int8
    product; buckets 1 and 4 the hand-composed bf16 prefill and int8
    decode; the int8 count exact per replay and over the served load; the
    poison changing buckets 1 and 4 and not 8, and the restore; the bytes;
    the lane's streams under the margin rule against the fixed route."""
    engine, per = run["engine"], run["per_call"]
    cuda = engine.device.type == "cuda"
    r = run["replays"]
    check(same_bits(r[8]["tokens"], run["bf16_8"]["tokens"]),
          "auto bucket 8 differs from the bf16 model's bucket 8")
    for b in (1, 4):
        check(same_bits(r[b]["tokens"], run["composed"][b]),
              f"auto bucket {b} differs from bf16 prefill + int8 decode composed by hand")
    if cuda:
        check(run["replay_counts"] == {1: per, 4: per, 8: 0},
              f"int8_matmul launches a replay {run['replay_counts']}, want {per} at 1 and 4, "
              f"0 at 8")
        exact_counts(run["counts"], run["expected"], "the auto load")
    for b in (1, 4):
        check(not same_bits(run["poisoned"][b], r[b]["tokens"]),
              f"the int8 poison did not reach bucket {b}")
    check(same_bits(run["poisoned"][8], r[8]["tokens"]), "the int8 poison reached bucket 8")
    check(all(same_bits(run["restored"][b], r[b]["tokens"]) for b in r),
          "the restored lm_scale does not give the bytes back")
    by = run["bytes"]
    want = layers * ((4 * d_model * d_model + 2 * d_model * ffn) * 2
                     + (4 * d_model + ffn + d_model) * 4)
    check(by["bf16_layers"] == want and abs(by["auto"] - by["int8"] - want) <= AUTO_BYTES_TOL,
          f"auto {by['auto']} - int8 {by['int8']} = {by['auto'] - by['int8']}, want "
          f"{want} (the bf16 layer weights and biases) within {AUTO_BYTES_TOL}")
    check(by["addresses"] == by["tensors"], f"shared addresses: {by}")
    held = hold_streams(engine, "gpt2_auto", run["streams"], AUTO["gen_slots"],
                        (LORA["chunk"], LORA["block_size"]))
    cmt = check_metrics_tool()
    problems = cmt.check(run["prometheus"], cmt.load_manifest())
    check(not problems, f"/metrics against the manifest: {problems}")
    return {"streams": held}


def run_adapters(card: str, profile: bool = False) -> dict:
    """Phase 18: multi-tenant adapters (a) and the regime-routed lane (b)."""
    t0 = time.perf_counter()
    fresh_memory()
    lrun = phase_lora_path(lora_config())
    engine = lrun["engine"]
    try:
        log_memory("adapters", engine)
        lheld = check_lora(lrun)
    finally:
        engine.shutdown()
    del engine
    b, a = lrun["burst"], lrun["rates"]
    log(f"{card}: adapters (alpha {lrun['alpha']}): attach ms {lrun['attach_ms']}, over the "
        f"cycles {[c['attach_ms'] for c in lrun['cycles']]}; the cold request 503 with estimate "
        f"{lrun['cycles'][0]['cold']['estimated_attach_ms']} ms, Retry-After "
        f"{lrun['cycles'][0]['cold']['retry_after']}; memory_allocated over the cycles "
        f"{[c.get('mem_delta') for c in lrun['cycles']]} bytes; co-batched dispatches "
        f"{lrun['multi_adapter_batches']}")
    log(f"{card}: adapters: the burst's rows byte-equal to their masked runs and the base's to "
        f"gpt2_base; against each alone at bucket 1: "
        f"{sum(b['tokens'][n] == b['alone'][n] for n in b['tokens'])} of 4 byte-equal, the "
        f"margin rule decided {lheld['burst']['decided_share']:.3f} (error "
        f"{lheld['burst']['err_max']:.4g}); streams decided "
        f"{lheld['streams']['decided_share']:.3f} (error {lheld['streams']['err_max']:.4g})")
    if "replay_ms" in lrun:
        rm = lrun["replay_ms"]
        log(f"{card}: adapters: a bucket-4 generate call replayed, three tenants and the base "
            f"{rm['adapters']:.4f} ms, the adapter-free model {rm['base']:.4f} ms (the LoRA "
            f"delta {rm['adapters'] - rm['base']:.4f} ms, {rm['adapters'] / rm['base']:.3f} x)")
    log(f"{card}: adapters: bursts of 8 streams in turn on the warmed lane, tokens/s (TTFT p50 "
        f"ms): adapter " + ", ".join(f"{r['tok_per_s']:.1f} ({r['ttft_p50']:.1f})"
                                     for r in a["adapter"])
        + "; base " + ", ".join(f"{r['tok_per_s']:.1f} ({r['ttft_p50']:.1f})" for r in a["base"]))
    fresh_memory()
    arun = phase_auto_path(auto_config(), profile=profile)
    engine = arun["engine"]
    try:
        log_memory("auto", engine)
        aheld = check_auto(arun)
    finally:
        engine.shutdown()
    by = arun["bytes"]
    log(f"{card}: auto: int8_matmul {arun['per_call']} launches a replay at buckets 1 and 4, "
        f"0 at 8; {arun['counts']['int8_matmul']} on the served load; bytes auto "
        f"{by['auto']}, int8 {by['int8']}, difference {by['auto'] - by['int8']} (bf16 layers "
        f"{by['bf16_layers']}); streams decided {aheld['streams']['decided_share']:.3f} "
        f"(error {aheld['streams']['err_max']:.4g}); {arun['rate']['tok_per_s']:.1f} tokens/s")
    for (n, bkt), ms in sorted(arun.get("call_ms", {}).items()):
        log(f"{card}: a generate call replayed, {n} bucket ({bkt}, 64): {ms:.4f} ms")
    log(f"{card}: phase 18 in {time.perf_counter() - t0:.3f} s")
    return {"auto_launches": arun["counts"]["int8_matmul"], "lora": lrun, "auto": arun}


# -- phase 19: the tenancy and control planes --------------------------------

# The family gpt2x: GPT-2 small bf16 (rank 2, speculation with the family's
# lowest rung as its draft) and int8 (rank 1), both on paged lanes, at
# :predict buckets (1, 4, 8) x 64 and 32 new tokens.  ``gpt2_probe`` is a
# pinned bf16 GPT-2 small at (1,) x 16 and one new token: the model served
# beside a pre-warm, and the chaos target of the autoscaler's checks.
TEN = {"seq_buckets": (64,), "batch_buckets": (1, 4, 8), "max_new_tokens": 32, "gen_slots": 8,
       "segment_tokens": 8, "block_size": 16, "chunk": 64, "spec_k": 4}
TEN_SPEC_M = TEN["gen_slots"] * (TEN["spec_k"] + 1)  # the verify forward's rows
TEN_SPEC_STREAMS = 8       # greedy streams with the draft on, then off
TEN_SLOW_EVIDENCE = 4      # slow gpt2_bf16 answers that make its forecast
TEN_REFILL = 6             # fast gpt2_bf16 answers after the fault, its evidence again
# The brownout's objective and the latency rule that breaks it on gpt2_bf16
# (the card serves either rung's bucket-1 call in ~30 ms).
TEN_OBJECTIVE_MS = 100.0
TEN_FAULT_MS = 150.0
TEN_EXIT_TICKS = 3
TEN_MIN_HOLD_S = 2.0
TEN_SELECT_REPS = 2000     # selections timed on the server's loop
TEN_ERRORS = 3             # the error burst of the SLO check
TEN_PROMPT = 40            # the prefix-cache stream's prompt (2 full pages)
# The autoscaler's check: periodic arrivals at gpt2_bf16, the period from
# the measured host-tier restore plus the idle timer and TEN_SLACK_S.
TEN_IDLE_S = 1.0
TEN_SLACK_S = 1.5
# At least this period, so the median gap's bucket is 10 s: room for both
# rungs' restores between the last arrival and the predicted one.
TEN_MIN_PERIOD_S = 5.5
TEN_MIN_HISTORY = 3
TEN_ARRIVALS = 6           # arrivals 1-3 find it demoted, 4 and 5 warm
TEN_MISPREDICT = 2
TEN_HOLD_S = 2.0


def tenancy_config(arch: dict | None = None, **extra):
    """Phase 19's deployment: the family ``gpt2x`` (``gpt2_bf16`` with
    ``spec_draft: "auto"``, ``gpt2_int8``) and the pinned ``gpt2_probe``,
    an objective for ``gpt2x`` with a 30 s fast window, the brownout's
    hysteresis, and a 0.1 s autoscaler and reaper tick."""
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig

    lane = {"max_new_tokens": TEN["max_new_tokens"], "gen_slots": TEN["gen_slots"],
            "segment_tokens": TEN["segment_tokens"], **({"arch": arch} if arch else {})}
    common = {"builder": "gpt2", "family": "gpt2x", "dtype": "bfloat16",
              "batch_buckets": TEN["batch_buckets"], "seq_buckets": TEN["seq_buckets"],
              "kv_cache": "paged", "kv_block_size": TEN["block_size"],
              "prefill_chunk_tokens": TEN["chunk"]}
    return ServeConfig(
        brownout_exit_ticks=TEN_EXIT_TICKS, brownout_min_hold_s=TEN_MIN_HOLD_S,
        slo={"gpt2x": {"latency_objective_ms": 5000.0, "availability_target": 0.99}},
        slo_fast_window_s=30.0, autoscale_tick_s=0.1, lifecycle_tick_s=0.1,
        autoscale_min_history=TEN_MIN_HISTORY, autoscale_mispredict_limit=TEN_MISPREDICT,
        autoscale_reactive_hold_s=TEN_HOLD_S,
        models=[
            # No prefix cache on the speculative lane: a hit decodes plain.
            ModelConfig(name="gpt2_bf16", quality_rank=2, spec_draft="auto",
                        spec_k=TEN["spec_k"], prefix_cache=False, **common,
                        extra={**lane, "params_dtype": "bfloat16"}),
            ModelConfig(name="gpt2_int8", quality_rank=1, **common,
                        extra={**lane, "params_dtype": "int8", **extra}),
            ModelConfig(name="gpt2_probe", builder="gpt2", dtype="bfloat16", batch_buckets=(1,),
                        seq_buckets=(16,), pinned=True,
                        extra={"max_new_tokens": 1, "params_dtype": "bfloat16",
                               **({"arch": arch} if arch else {})})])


def trace_points(port: int, trace_id: str) -> list[str]:
    """The names of every span and point of one request's trace."""
    status, body, _ = http_h(port, f"/admin/trace/{trace_id}")
    check(status == 200, f"trace {trace_id}: {status} {body}")
    names, todo = [], [body["trace"]["tree"]]
    while todo:
        node = todo.pop()
        names.append(node.get("name"))
        todo += node.get("children", [])
    return names


def ten_selection(port: int, engine, vocab: int) -> dict:
    """Check 1: a family :predict with no pressure is the top rung's answer,
    ``prefer_cost`` the int8 rung's, each equal to the rung addressed
    directly (the same bucket).  The int8 launches are those of the two
    int8 calls' replays exactly.  (The ``min_quality`` shed, which enters
    brownout, closes check 2.)"""
    rng = np.random.default_rng(41)
    body = {"input_ids": rng.integers(0, vocab - 1, 24).tolist()}
    reset_counts()
    st, fam, h = http_h(port, "/v1/models/gpt2x:predict", body)
    check(st == 200 and h.get("X-Served-Variant") == "gpt2_bf16" and "X-Degraded" not in h
          and fam.get("family") == "gpt2x" and fam.get("degraded") is False,
          f"family :predict: {st} {h.get('X-Served-Variant')} {fam}")
    st, exact, _ = http_h(port, "/v1/models/gpt2_bf16:predict", body)
    check(st == 200 and json.dumps(fam["predictions"]) == json.dumps(exact["predictions"]),
          f"the family's answer {fam['predictions']} is not gpt2_bf16's {exact}")
    st, cheap, h = http_h(port, "/v1/models/gpt2x:predict",
                          {**body, "objective": {"prefer_cost": True}})
    check(st == 200 and h.get("X-Served-Variant") == "gpt2_int8" and h.get("X-Degraded") == "1",
          f"prefer_cost: {st} {h}")
    st, exact8, _ = http_h(port, "/v1/models/gpt2_int8:predict", body)
    check(st == 200 and json.dumps(cheap["predictions"]) == json.dumps(exact8["predictions"]),
          f"prefer_cost's answer {cheap['predictions']} is not gpt2_int8's {exact8}")
    counts = read_counts()
    cm = engine.model("gpt2_int8")
    per_call = (4 * cm.servable.meta["config"].layers + 1) * (1 + TEN["max_new_tokens"])
    if engine.device.type == "cuda":
        exact_counts(counts, {"int8_matmul": 2 * per_call}, "the selection check")
    return {"per_call": per_call, "int8_launches": counts["int8_matmul"],
            "tokens": fam["predictions"]["tokens"]}


def ten_brownout(srv, port: int, vocab: int) -> dict:
    """Check 2: a latency rule on gpt2_bf16 makes its forecast pass the
    objective; family :predict and a family :generate stream are served by
    gpt2_int8, degraded, the brownout gauge 1.  The rule cleared and fast
    answers refilling the evidence, the family leaves only after its exit
    ticks and its hold, each transition counted once.  Then a
    ``min_quality`` above the ladder sheds 429 with the family's minimum
    Retry-After."""
    server = srv.server
    faults = server.engine.runner.faults
    check(not server.variants.brownout.active("gpt2x"), "gpt2x in brownout before the rule")
    rng = np.random.default_rng(43)
    body = {"input_ids": rng.integers(0, vocab - 1, 20).tolist()}
    obj = {"X-Objective-Max-Latency-Ms": f"{TEN_OBJECTIVE_MS:g}"}
    faults.configure(model="gpt2_bf16", latency_ms=TEN_FAULT_MS)
    for _ in range(TEN_SLOW_EVIDENCE):
        st, _, _ = http_h(port, "/v1/models/gpt2_bf16:predict", body)
        check(st == 200, f"gpt2_bf16 under the latency rule: {st}")
    t_enter = time.perf_counter()
    st, ans, h = http_h(port, "/v1/models/gpt2x:predict", body, obj)
    enter_s = time.perf_counter() - t_enter
    check(st == 200 and h.get("X-Served-Variant") == "gpt2_int8" and h.get("X-Degraded") == "1"
          and ans.get("degraded") is True, f"family :predict under pressure: {st} {h} {ans}")
    gen = sse(port, "gpt2x", {"input_ids": body["input_ids"], "max_new_tokens": 8}, headers=obj)
    check(gen["status"] == 200 and gen["headers"].get("X-Served-Variant") == "gpt2_int8"
          and gen["headers"].get("X-Degraded") == "1" and gen["final"] and gen["final"]["done"],
          f"family :generate under pressure: {gen['status']} {gen['headers']}")
    status, prom = http_text(port, "/metrics?format=prometheus")
    check('tpuserve_variant_brownout_state{family="gpt2x"} 1' in prom,
          "tpuserve_variant_brownout_state is not 1 under brownout")
    bc = server.variants.brownout
    entered_at = bc._entered_at["gpt2x"]
    faults.clear("gpt2_bf16")
    for _ in range(TEN_REFILL):
        st, _, _ = http_h(port, "/v1/models/gpt2_bf16:predict", body)
        check(st == 200, f"gpt2_bf16 after the rule: {st}")
    picks, t0 = [], time.perf_counter()
    while True:
        st, ans, h = http_h(port, "/v1/models/gpt2x:predict", body, obj)
        check(st == 200, f"family :predict while recovering: {st} {ans}")
        picks.append((time.perf_counter() - t0, h.get("X-Served-Variant"),
                      h.get("X-Degraded") == "1"))
        if picks[-1][1] == "gpt2_bf16":
            break
        check(time.perf_counter() - t0 < 30.0, f"the family never left brownout: {picks}")
        time.sleep(0.1)
    exit_held = time.monotonic() - entered_at
    check(not picks[-1][2] and len(picks) >= TEN_EXIT_TICKS and exit_held >= TEN_MIN_HOLD_S
          and all(v == "gpt2_int8" and d for _, v, d in picks[:-1]),
          f"brownout left after {len(picks)} clean selections and {exit_held:.3f} s: {picks}")
    check(bc.transitions["gpt2x"] == {"enter": 1, "exit": 1},
          f"brownout transitions {bc.transitions}")
    st, shed, h = http_h(port, "/v1/models/gpt2x:predict", body, {"X-Objective-Min-Quality": "3"})
    floor_s = max((shed.get("estimated_wait_ms") or 0.0) / 1000.0, 0.05)
    check(st == 429 and shed.get("variant_shed") == "no_variant_fits"
          and shed.get("family") == "gpt2x"
          and int(h["Retry-After"]) == max(math.ceil(floor_s), 1),
          f"min_quality above the ladder: {st} {shed} Retry-After {h.get('Retry-After')}")

    async def time_select():
        from pytorch_zappa_serverless_tpu_torch.serving.variants import Objective, VariantHub

        hub, objective, out = VariantHub(server.cfg), Objective(), []
        for _ in range(TEN_SELECT_REPS):
            t = time.perf_counter()
            hub.resolve(server, "gpt2x", objective, None)
            out.append((time.perf_counter() - t) * 1000.0)
        return out

    sel = srv.call(time_select)
    return {"enter_s": enter_s, "exit_held_s": exit_held, "picks": picks,
            "shed_retry_after": h["Retry-After"],
            "select_p50_ms": float(np.percentile(sel, 50)),
            "select_p99_ms": float(np.percentile(sel, 99)),
            "select_hist": server.variants.select_hists["gpt2x"].snapshot()}


def ten_spec(srv, port: int, vocab: int) -> dict:
    """Check 3: ``spec_draft: "auto"`` drafts gpt2_bf16's lane with
    gpt2_int8: the same greedy streams with the draft resident (proposals,
    ``X-Spec-Draft``) and with it demoted to the host tier (the lane decodes
    plain), on and off on one lane; the draft restored after."""
    sched = srv.server.schedulers["gpt2_bf16"]
    rng = np.random.default_rng(47)
    bodies = [{"input_ids": rng.integers(0, vocab - 1, int(rng.integers(5, 61))).tolist(),
               "max_new_tokens": TEN["max_new_tokens"]} for _ in range(TEN_SPEC_STREAMS)]
    s0 = dict(sched.gen_snapshot()["spec"])
    on, on_wall = gen_burst(port, "gpt2_bf16", bodies)
    s1 = dict(sched.gen_snapshot()["spec"])
    check(all(r["status"] == 200 for r in on), f"draft on: {[r['status'] for r in on]}")
    check_sse(on, vocab)
    check(all(r["headers"].get("X-Spec-Draft") == "gpt2_int8" for r in on)
          and all(r["final"].get("stats", {}).get("spec_proposed", 0) > 0 for r in on),
          f"the auto draft: headers {[r['headers'].get('X-Spec-Draft') for r in on]}")
    status, body = http(port, "/admin/models/gpt2_int8", {"action": "demote", "to": "host"})
    check(status == 200, f"the draft's demotion: {status} {body}")
    off, off_wall = gen_burst(port, "gpt2_bf16", bodies)
    s2 = dict(sched.gen_snapshot()["spec"])
    check(all(r["status"] == 200 for r in off), f"draft off: {[r['status'] for r in off]}")
    check_sse(off, vocab)
    check(all("X-Spec-Draft" not in r["headers"] for r in off) and s2["proposed"] == s1["proposed"]
          and s2["fallback_ticks"] > s1["fallback_ticks"],
          f"with the draft demoted: {s1} -> {s2}")
    status, body = http(port, "/admin/models/gpt2_int8", {"action": "activate"})
    check(status == 200, f"the draft's restore: {status} {body}")
    return {"bodies": bodies, "on": on, "off": off,
            "stats": {k: s1[k] - s0[k] for k in ("proposed", "accepted", "fallback_ticks")},
            "tok_per_s": {"on": stream_stats(on, on_wall)["tok_per_s"],
                          "off": stream_stats(off, off_wall)["tok_per_s"]}}


def ten_slo(srv, port: int, vocab: int) -> dict:
    """Check 4: the outcome counts of /admin/slo against what the client
    saw, by status and by degraded; an ``error`` burst flipping the fast
    alarm on /healthz while health stays ok; the usage ledger's device ms
    against the answers' ``X-Device-Ms``, and a stream's KV page-seconds
    and prefix tokens against its final events."""
    server = srv.server
    faults = server.engine.runner.faults
    srv.call(server.slo._trackers.clear)
    usage0 = server.slo.usage.snapshot()
    rng = np.random.default_rng(53)
    body = {"input_ids": rng.integers(0, vocab - 1, 16).tolist()}
    saw: dict = {}
    device_ms: dict = {}
    for path, heads, b in (("gpt2_bf16", {}, body), ("gpt2_bf16", {}, body),
                           ("gpt2x", {"X-Objective-Prefer-Cost": "1"}, body),
                           ("gpt2x", {"X-Objective-Prefer-Cost": "1"}, body),
                           ("gpt2_bf16", {"X-Deadline-Ms": "0"}, body),
                           ("gpt2_int8", {}, {"input_ids": "junk"})):
        st, ans, h = http_h(port, f"/v1/models/{path}:predict", b, heads)
        model = h.get("X-Served-Variant") or path
        if st == 200:
            kind = "degraded" if h.get("X-Degraded") == "1" else "good"
            device_ms[model] = device_ms.get(model, 0.0) + float(h["X-Device-Ms"])
        elif st in (429, 503, 504):
            kind = "shed"
        else:
            check(st == 400, f"{path}: {st} {ans}")
            continue
        saw.setdefault(model, {}).setdefault(kind, 0)
        saw[model][kind] += 1
    status, slo, _ = http_h(port, "/admin/slo")
    for model, want in saw.items():
        got = {k: v for k, v in slo["models"][model]["predict"]["outcomes"].items() if v}
        check(got == want, f"/admin/slo outcomes of {model}: {got}, the client saw {want}")
    usage1 = server.slo.usage.snapshot()
    for model, ms in device_ms.items():
        spent = usage1[model]["device_ms"] - usage0.get(model, {}).get("device_ms", 0.0)
        check(spent >= ms - 1e-3 * 4, f"{model}: the ledger's device ms {spent} under the "
                                      f"answers' {ms}")
    status, health, _ = http_h(port, "/healthz")
    check("gpt2_int8|predict" not in health["slo"]["fast_alarms"],
          f"gpt2_int8's fast alarm before the burst: {health['slo']}")
    faults.configure(model="gpt2_int8", fail_every_n=1, count=TEN_ERRORS, kind="fatal")
    errors = [http_h(port, "/v1/models/gpt2_int8:predict", body)[0] for _ in range(TEN_ERRORS)]
    faults.clear("gpt2_int8")
    check(errors == [500] * TEN_ERRORS, f"the error burst: {errors}")
    status, health, _ = http_h(port, "/healthz")
    check(status == 200 and health.get("device_ok") is True
          and "gpt2_int8|predict" in health["slo"]["fast_alarms"],
          f"/healthz after the burst: {status} {health.get('slo')}")
    status, slo, _ = http_h(port, "/admin/slo")
    lane = slo["models"]["gpt2_int8"]["predict"]
    check(lane["outcomes"]["error"] == TEN_ERRORS and lane["windows"]["fast"]["alarm"],
          f"gpt2_int8 after the burst: {lane}")
    prompt = rng.integers(0, vocab - 1, TEN_PROMPT).tolist()
    cached = 0
    for _ in range(2):
        r = sse(port, "gpt2_int8", {"input_ids": prompt, "max_new_tokens": 8})
        check(r["status"] == 200 and r["final"] and r["final"]["done"], f"stream {r['status']}")
        cached += r["final"].get("stats", {}).get("prefix_cached_tokens", 0)
    usage2 = server.slo.usage.snapshot()["gpt2_int8"]
    saved = usage2["prefix_saved_tokens"] - usage1["gpt2_int8"]["prefix_saved_tokens"]
    pages_s = usage2["kv_block_seconds"] - usage1["gpt2_int8"]["kv_block_seconds"]
    check(cached > 0 and saved == cached and pages_s > 0,
          f"the streams' bill: {saved} saved tokens against {cached} cached, {pages_s} "
          f"page-seconds")
    return {"saw": saw, "device_ms": device_ms, "burn": lane["windows"]["fast"]["burn_rate"],
            "cached": cached, "page_s": pages_s}


def ten_autoscale(srv, port: int, vocab: int) -> dict:
    """Check 5: the autoscaler on the live server.  The host-tier restore
    of each rung measured first sets the arrivals' period; (a) periodic
    arrivals at gpt2_bf16 find it demoted until the history is in, and
    warm after; (b) with both rungs demoted, the pre-warm activates them
    before the next predicted arrival, which waits for no activation,
    while ``gpt2_probe`` is served beside it (its stall printed); (c)
    ``starve`` drops the plane to reactive after its mispredict limit; (d)
    ``spike`` arrivals never reach the journal."""
    server = srv.server
    plane, lc, faults = server.autoscale, server.lifecycle, server.engine.runner.faults
    rng = np.random.default_rng(59)
    body = {"input_ids": rng.integers(0, vocab - 1, 12).tolist()}
    probe = {"input_ids": [5, 6, 7]}
    out: dict = {"restore_ms": {}}
    for name in ("gpt2_bf16", "gpt2_int8"):
        status, ans = http(port, f"/admin/models/{name}", {"action": "demote", "to": "host"})
        check(status == 200, f"{name} to host: {status} {ans}")
        status, ans = http(port, f"/admin/models/{name}", {"action": "activate"})
        check(status == 200, f"{name} restored: {status} {ans}")
        out["restore_ms"][name] = ans["model"]["last_activation_ms"]
    restore_s = out["restore_ms"]["gpt2_bf16"] / 1000.0
    period = max(restore_s + TEN_IDLE_S + TEN_SLACK_S, TEN_MIN_PERIOD_S)
    out["period_s"] = period
    log(f"autoscale: host-tier restores {out['restore_ms']} ms; arrivals every {period:.3f} s")

    def knobs():
        server.cfg.idle_unload_s = TEN_IDLE_S
        server.cfg.host_idle_drop_s = 3600.0
        plane._models.pop("gpt2_bf16", None)
        plane.prewarm_margin_s = out["restore_ms"]["gpt2_int8"] / 1000.0 + 2.0
        lc.start()

    srv.call(knobs)
    state = lambda n: srv.call(lc.state_of, n)  # noqa: E731
    # (a) The learned window.
    status, ans = http(port, "/admin/models/gpt2_bf16", {"action": "demote", "to": "host"})
    check(status == 200, f"gpt2_bf16 to host: {status} {ans}")
    found, t_next, sent = [], time.perf_counter(), 0.0
    for k in range(TEN_ARRIVALS):
        time.sleep(max(t_next - time.perf_counter(), 0.0))
        before = state("gpt2_bf16")
        sent = time.perf_counter()
        st, ans, h = http_h(port, "/v1/models/gpt2_bf16:predict", body)
        check(st == 200, f"arrival {k}: {st} {ans}")
        waited = "activation_wait" in trace_points(port, h["X-Trace-Id"])
        found.append((before, waited))
        t_next = sent + period
    want = [True] * (TEN_MIN_HISTORY + 1) + [False] * (TEN_ARRIVALS - TEN_MIN_HISTORY - 1)
    check([b != "active" for b, _ in found] == want and [w for _, w in found] == want,
          f"arrivals' residency (state, waited) {found}; want demoted {want}")
    _, snap, _ = http_h(port, "/admin/autoscale")
    m = snap["models"]["gpt2_bf16"]
    out["window_s"], out["median_gap_s"] = m["keepwarm_window_s"], m["median_gap_s"]
    check(m["keepwarm_window_s"] is not None and m["keepwarm_window_s"] >= period,
          f"the learned window {m}")
    # (b) The pre-warm, with gpt2_probe served beside it.  The draft may
    # already be on the host (the idle timer's).
    for name in ("gpt2_bf16", "gpt2_int8"):
        status, ans = http(port, f"/admin/models/{name}", {"action": "demote", "to": "host"})
        check(status == 200 or (status == 409 and ans["model"]["state"] != "active"),
              f"{name} to host: {status} {ans}")
    est_ms = srv.call(lc.estimate_warm_ms, "gpt2_bf16")  # what the plane's lead reads
    lat, stop = [], threading.Event()

    def probing():
        while not stop.is_set():
            t = time.perf_counter()
            st, _, _ = http_h(port, "/v1/models/gpt2_probe:predict", probe)
            lat.append((t, (time.perf_counter() - t) * 1000.0, st))

    th = threading.Thread(target=probing, daemon=True)
    th.start()
    due = sent + m["median_gap_s"]
    both = None  # when both rungs were first active together
    while time.perf_counter() < due:
        if both is None and all(state(n) == "active" for n in ("gpt2_bf16", "gpt2_int8")):
            both = time.perf_counter() - sent
        time.sleep(0.05)
    states = {"gpt2_bf16": state("gpt2_bf16"), "both_active_at_s": both}
    st, ans, h = http_h(port, "/v1/models/gpt2_bf16:predict", body)
    stop.set()
    th.join(60)
    check(st == 200, f"the predicted arrival: {st} {ans}")
    points = trace_points(port, h["X-Trace-Id"])
    _, models, _ = http_h(port, "/admin/models")
    causes = {n: models["models"][n]["activations_by_cause"] for n in ("gpt2_bf16", "gpt2_int8")}
    check(states["gpt2_bf16"] == "active" and both is not None
          and "activation_wait" not in points and "cold_start" not in points
          and causes["gpt2_bf16"].get("prewarm", 0) >= 1
          and causes["gpt2_int8"].get("prewarm_draft", 0) >= 1,
          f"the pre-warm: states at the arrival {states}, its trace {points}, causes {causes}")
    _, snap, _ = http_h(port, "/admin/autoscale")
    check(snap["counters"]["prewarms"] >= 1 and snap["counters"]["prewarm_hits"] >= 1
          and snap["counters"]["prewarm_errors"] == 0, f"pre-warm counters {snap['counters']}")
    ok = [x for _, x, s in lat if s == 200]
    check(len(ok) == len(lat) and len(ok) >= 3, f"the probe beside the pre-warm: {lat[:4]}")
    out["prewarm"] = {"lead_s": est_ms / 1000.0 + plane.prewarm_margin_s, "estimate_ms": est_ms,
                      "both_active_s": both, "due_s": m["median_gap_s"],
                      "activation_ms": {n: models["models"][n]["last_activation_ms"]
                                        for n in ("gpt2_bf16", "gpt2_int8")},
                      "probe_p50_ms": float(np.percentile(ok, 50)),
                      "probe_max_ms": max(ok), "probe_calls": len(ok)}
    # (c) starve: phantom predictions on the probe walk the plane down.
    # The earlier checks' traffic is not periodic, so the plane may already
    # have mispredicted and held reactive on its own: start from a plane
    # out of any hold and count what the rule adds.
    srv.call(setattr, plane, "prewarm_margin_s", 0.25)
    wait_until(lambda: not http_h(port, "/admin/autoscale")[1]["degraded"], TEN_HOLD_S + 10.0,
               "the plane out of a reactive hold before starve")
    pre = http_h(port, "/admin/autoscale")[1]
    before = {**pre["counters"], "mispredict_streak": pre["mispredict_streak"]}
    out["counters_before_starve"] = before
    faults.configure(model="gpt2_probe", kind="demand", mode="starve", fail_every_n=1)
    t0 = time.perf_counter()
    while True:
        _, snap, _ = http_h(port, "/admin/autoscale")
        if snap["degraded"]:
            break
        check(time.perf_counter() - t0 < 30.0, f"starve never degraded the plane: {snap}")
        time.sleep(0.1)
    out["degrade_s"] = time.perf_counter() - t0
    faults.clear("gpt2_probe")
    added = {k: snap["counters"][k] - before[k] for k in ("degradations", "prewarm_misses")}
    check(snap["effective_mode"] == "reactive" and added["degradations"] == 1
          and added["prewarm_misses"] >= TEN_MISPREDICT - before["mispredict_streak"]
          and snap["models"]["gpt2_probe"]["prewarms_by_cause"].get("phantom", 0) >= 1,
          f"the plane under starve: {snap['counters']}, before it {before}")
    wait_until(lambda: not http_h(port, "/admin/autoscale")[1]["degraded"], TEN_HOLD_S + 10.0,
               "the plane's reactive hold to expire")
    # (d) spike: the arrivals happen, the journal never sees them.
    seen = srv.call(lambda: plane._models["gpt2_probe"].arrivals)
    injected = faults.snapshot()["injected"]["demand"]
    faults.configure(model="gpt2_probe", kind="demand", mode="spike", fail_every_n=1)
    for _ in range(3):
        check(http_h(port, "/v1/models/gpt2_probe:predict", probe)[0] == 200, "spiked arrival")
    faults.clear("gpt2_probe")
    # The control tick consults the rule too (for a phantom), so the rule
    # fires at least once an arrival.
    after = (srv.call(lambda: plane._models["gpt2_probe"].arrivals),
             faults.snapshot()["injected"]["demand"])
    check(after[0] == seen and after[1] >= injected + 3,
          f"spike: the journal's arrivals {seen} -> {after[0]}, the rule fired "
          f"{after[1] - injected} times for 3 arrivals")

    def calm():
        server.cfg.idle_unload_s = 0.0

    srv.call(calm)
    for name in ("gpt2_bf16", "gpt2_int8"):  # the reactive timer may have taken them
        status, ans = http(port, f"/admin/models/{name}", {"action": "activate"})
        check(status == 200, f"{name} activated after the checks: {status} {ans}")
    out["found"] = found
    out["counters"] = snap["counters"]
    return out


def phase_tenancy_path(cfg, device: str = "cuda", vocab: int = 50257) -> dict:
    """Phase 19: serve the family and the probe, and run checks 1-6 on the
    live server (the kernel counts reset before and read after); the
    speculative streams are held against the fixed route afterwards."""
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine
    from pytorch_zappa_serverless_tpu_torch.ops import counters
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    t0 = time.perf_counter()
    engine = build_engine(cfg, device)
    log(f"tenancy engines ready in {time.perf_counter() - t0:.3f} s on {engine.device}: "
        f"build {engine.build_seconds}")
    out: dict = {"engine": engine}
    with BackgroundServer(cfg, engine) as srv:
        port, scheds = srv.port, srv.server.schedulers
        engine.runner.run_fn_sync(scheds["gpt2_bf16"].warm, engine.model("gpt2_int8"))
        engine.runner.run_fn_sync(scheds["gpt2_int8"].warm)
        out["select"] = ten_selection(port, engine, vocab)
        reset_counts()
        out["brownout"] = ten_brownout(srv, port, vocab)
        out["spec"] = ten_spec(srv, port, vocab)
        out["slo"] = ten_slo(srv, port, vocab)
        out["autoscale"] = ten_autoscale(srv, port, vocab)
        out["counts"] = read_counts()  # just after the load
        out["graphed"] = counters.graphed()
        status, prom = http_text(port, "/metrics?format=prometheus")
        check(status == 200, f"/metrics?format=prometheus: {status}")
        out["prometheus"] = prom
    return out


def check_tenancy(run: dict, vocab: int = 50257) -> dict:
    """Checks 3, 6 and 7 on the load's answers: the speculative streams
    under the margin rule with the draft on and off; /metrics against the
    manifest with the planes' families; every int8 launch of the phase in a
    captured graph's warm-up or replay."""
    engine = run["engine"]
    sp = run["spec"]
    paged = (TEN["chunk"], TEN["block_size"])
    on = lane_streams(sp["bodies"], sp["on"], TEN["max_new_tokens"], "on")
    off = lane_streams(sp["bodies"], sp["off"], TEN["max_new_tokens"], "off")
    st = sp["stats"]
    check(st["proposed"] > 0 and 0 < st["accepted"] <= st["proposed"]
          and st["fallback_ticks"] == 0, f"the auto draft's speculation: {st}")
    held_on = hold_streams(engine, "gpt2_bf16", on, TEN_SPEC_M, paged, keep_refs=True)
    held_off = hold_streams(engine, "gpt2_bf16", off, TEN["gen_slots"], paged,
                            err=held_on["err_max"])
    div = diverge_undecided(held_on.pop("refs"), held_on["err_max"], on, off)
    cmt = check_metrics_tool()
    problems = cmt.check(run["prometheus"], cmt.load_manifest())
    check(not problems, f"/metrics against the manifest: {problems}")
    for fam in ("tpuserve_variant_selections_total", "tpuserve_variant_degraded_total",
                "tpuserve_variant_sheds_total", "tpuserve_variant_brownout_state",
                "tpuserve_variant_brownout_transitions_total", "tpuserve_variant_select_ms",
                "tpuserve_slo_requests_total", "tpuserve_slo_burn_rate",
                "tpuserve_slo_burn_alarm", "tpuserve_slo_goodput_ratio",
                "tpuserve_slo_budget_remaining", "tpuserve_usage_requests_total",
                "tpuserve_usage_device_ms_total", "tpuserve_usage_kv_block_seconds_total",
                "tpuserve_usage_prefix_saved_tokens_total", "tpuserve_autoscale_forecast_rps",
                "tpuserve_autoscale_keepwarm_window_s", "tpuserve_autoscale_prewarm_total"):
        check(f"# TYPE {fam} " in run["prometheus"], f"{fam} missing from /metrics")
    counts, graphed = run["counts"], run["graphed"]
    check(counts["int8_matmul"] == graphed["int8_matmul"]
          and all(counts[k] == 0 for k in counts if k not in ("int8_matmul",)),
          f"phase 19's launches {counts}, in graphs {graphed}")
    return {"on": held_on, "off": held_off, "diverge": div,
            "rate": st["accepted"] / max(st["proposed"], 1)}


def run_tenancy(card: str) -> dict:
    """Phase 19: the tenancy and control planes on the card."""
    t0 = time.perf_counter()
    fresh_memory()
    run = phase_tenancy_path(tenancy_config())
    engine = run["engine"]
    try:
        log_memory("tenancy", engine)
        held = check_tenancy(run)
    finally:
        engine.shutdown()
    sel, bo, sp, slo, au = (run["select"], run["brownout"], run["spec"], run["slo"],
                            run["autoscale"])
    launches = sel["int8_launches"] + run["counts"]["int8_matmul"]
    log(f"{card}: variants: the family's answers equal each rung's; int8_matmul "
        f"{sel['int8_launches']} launches for the two int8 calls ({sel['per_call']} a call); "
        f"selection {bo['select_p50_ms']:.4f} ms p50, {bo['select_p99_ms']:.4f} ms p99 over "
        f"{TEN_SELECT_REPS} on the server's loop")
    log(f"{card}: brownout: entered on the first family request after the rule "
        f"({bo['enter_s'] * 1e3:.1f} ms round trip), left after {len(bo['picks'])} clean "
        f"selections and {bo['exit_held_s']:.3f} s held (exit ticks {TEN_EXIT_TICKS}, hold "
        f"{TEN_MIN_HOLD_S} s)")
    log(f"{card}: auto draft gpt2_int8 under gpt2_bf16 (k={TEN['spec_k']}): "
        f"{sp['stats']['proposed']} proposed, {sp['stats']['accepted']} accepted (rate "
        f"{held['rate']:.4f}); tokens/s with the draft {sp['tok_per_s']['on']:.1f}, without "
        f"{sp['tok_per_s']['off']:.1f}; greedy on == off on {held['diverge']['equal']} of "
        f"{TEN_SPEC_STREAMS}, parted at undecided positions {held['diverge']['parted']}")
    log(f"{card}: slo: outcomes as the client saw {slo['saw']}; fast burn after the error "
        f"burst {slo['burn']}; a stream pair's bill {slo['page_s']:.4f} page-seconds, "
        f"{slo['cached']} prefix tokens saved")
    pw = au["prewarm"]
    log(f"{card}: autoscale: restores {au['restore_ms']} ms, period {au['period_s']:.3f} s, "
        f"learned window {au['window_s']} s (median gap {au['median_gap_s']} s); arrivals "
        f"(state, waited) {au['found']}; pre-warm lead {pw['lead_s']:.3f} s (estimate "
        f"{pw['estimate_ms']:.1f} ms) against activations {pw['activation_ms']} ms, both "
        f"rungs active {pw['both_active_s']:.3f} s after the last arrival, the predicted one "
        f"at {pw['due_s']} s; "
        f"gpt2_probe beside it {pw['probe_p50_ms']:.3f} ms p50, {pw['probe_max_ms']:.3f} ms "
        f"max over {pw['probe_calls']} calls (the stall behind the capture "
        f"{pw['probe_max_ms'] - pw['probe_p50_ms']:.3f} ms); starve degraded the plane in "
        f"{au['degrade_s']:.3f} s (before it {au['counters_before_starve']}); counters "
        f"{au['counters']}")
    log(f"{card}: phase 19 in {time.perf_counter() - t0:.3f} s; int8_matmul launches "
        f"{launches}, every one in a captured graph's warm-up or replay")
    return {"int8_launches": launches, "held": held}


# -- phase 20: the host ingest planes ---------------------------------------------

# The acceptor fast lane of phase 20: two worker processes, BERT-base int8
# (1, 8) x 128 and ResNet-50 bf16 (1, 8) at 224x224.
INGEST_WORKERS = 2
INGEST_SINGLES = 24        # sequential single frames a model and lane, check 1
INGEST_EIGHTS = 4          # sequential 8-instance frames a model and lane, check 1
INGEST_REQS = 40           # sequential single requests a model and lane, the client p50
INGEST_INFLIGHT = 4        # requests in flight at the kill -9, check 5
INGEST_SLOW_MS = 400       # the injected dispatch latency of checks 1 and 5
# Ring geometry: an 8-instance 224x224x3 uint8 frame is 1,204,224 bytes, past
# the reference's 1 MiB slot, so 2 MiB slots; as many as /dev/shm holds, up
# to INGEST_SLOTS (two rings a worker).
INGEST_SLOTS = 32
INGEST_SLOT_BYTES = 2 << 20
# The stages each lane's request crosses on its way to an answer.
FAST_STAGES = ("sock_read", "frame_validate", "ring_wait", "binary_decode", "validate",
               "batch_form", "serialize", "respond")
MAIN_STAGES = ("payload_read", "binary_decode", "validate", "batch_form", "serialize",
               "respond")
HOST_FAMILIES = ("tpuserve_loop_lag_ms", "tpuserve_loop_lag_max_ms", "tpuserve_ingest_ms",
                 "tpuserve_perf_samples_per_s", "tpuserve_perf_tokens_per_s",
                 "tpuserve_perf_step_ms", "tpuserve_perf_device_util_pct",
                 "tpuserve_perf_mfu_pct", "tpuserve_ingest_workers", "tpuserve_shm_ring_depth",
                 "tpuserve_shm_ring_occupancy_pct", "tpuserve_acceptor_accepts_total",
                 "tpuserve_acceptor_sheds_total", "tpuserve_acceptor_responses_total",
                 "tpuserve_acceptor_bytes_total", "tpuserve_acceptor_worker_up",
                 "tpuserve_acceptor_heartbeat_age_s", "tpuserve_acceptor_restarts_total",
                 "tpuserve_acceptor_inworker_ms", "tpuserve_acceptor_ring_wait_ms")


def bert_flops(layers: int = 12, seq: int = 128, d: int = 768, ffn: int = 3072,
               heads: int = 12) -> float:
    """FLOPs of one BERT-base sample at ``seq``: the 6 products a layer
    (2·seq·K·N each) and the two attention products (2·seq²·head_dim a
    head each)."""
    products = 2 * seq * (4 * d * d + 2 * d * ffn)
    attention = 2 * 2 * seq * seq * (d // heads) * heads
    return float(layers * (products + attention))


def ingest_config(bert_arch: dict | None = None, image_size: int = VISION_SIZE,
                  slots: int = INGEST_SLOTS, slot_bytes: int = INGEST_SLOT_BYTES,
                  gpt2_arch: dict | None = None):
    """BERT-base int8 (1, 8) x 128 with its FLOP hint and ResNet-50 bf16
    (1, 8), two acceptor workers, the perf plane on a window that spans the
    phase; GPT-2 small int8 on an 8-slot ``:generate`` lane beside them, for
    the plane's token gauges."""
    from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig

    a = bert_arch or {}
    flops = bert_flops(a.get("num_layers", 12), BERT["seq"],
                       a.get("num_heads", 12) * a.get("head_dim", 64), a.get("mlp_dim", 3072),
                       a.get("num_heads", 12))
    return ServeConfig(
        ingest_workers=INGEST_WORKERS, perfplane=True, perf_window_s=600.0,
        perf_loop_lag_interval_s=0.1, shm_ring_slots=slots, shm_ring_slot_bytes=slot_bytes,
        models=[
            ModelConfig(name="bert_base", dtype="bfloat16", seq_buckets=(BERT["seq"],),
                        batch_buckets=PLANE_BERT,
                        extra={"params_dtype": "int8", "flops_per_sample": flops,
                               **({"arch": bert_arch} if bert_arch else {})}),
            ModelConfig(name="resnet50", dtype="bfloat16", batch_buckets=PLANE_VISION,
                        extra={"image_size": image_size,
                               "resize_to": image_size * 8 // 7}),
            ModelConfig(name="gpt2", dtype="bfloat16", seq_buckets=(16,), batch_buckets=(1,),
                        extra={"params_dtype": "int8", **PLANE_GEN,
                               **({"arch": gpt2_arch} if gpt2_arch else {})})])


def ring_geometry() -> tuple[int, int, dict]:
    """(slots, slot bytes, the /dev/shm reading): INGEST_SLOT_BYTES slots, as
    many as fit half of /dev/shm's free bytes, at most INGEST_SLOTS."""
    import os

    st = os.statvfs("/dev/shm")
    free = st.f_bavail * st.f_frsize
    fits = free // 2 // (2 * INGEST_WORKERS * INGEST_SLOT_BYTES)
    slots = int(min(INGEST_SLOTS, fits))
    check(slots >= 4, f"/dev/shm holds {free} free bytes: not even 4 slots of "
                      f"{INGEST_SLOT_BYTES} bytes for {INGEST_WORKERS} workers' two rings")
    return slots, INGEST_SLOT_BYTES, {"size": st.f_blocks * st.f_frsize, "free": free}


def phase_ingest_path(cfg, device: str = "cuda", bert_vocab: int = 30522,
                      gpt2_vocab: int = 50257, per_forward: int = 72,
                      reqs: int = INGEST_REQS) -> dict:
    """Serve BERT-base int8 and ResNet-50 through two acceptor workers and
    check, in order: (1) fast-lane answers byte-decode equal to the main
    port's binary lane (INGEST_SINGLES single and INGEST_EIGHTS 8-instance
    frames a model, sent one at a time); at the worker a declared oversize
    413, a truncated frame 400, a JSON body 415, ``X-Deadline-MS: 1`` behind
    a slow dispatch 504, every error with ``request_id`` and ``trace_id``;
    (2) ``int8_matmul`` on the fast lane exactly ``per_forward`` × the BERT
    forwards the runner counted there, every one in a replay; (3) both
    workers alive and accepting, neither mapping libtorch; (4) a fast-lane
    BERT trace joining a given ``traceparent``, its chain sock_read,
    frame_validate, ring_wait, binary_decode, admission, queue, batch_form,
    device (exec inside), respond; (5) ``kill -9`` of a worker with requests
    in flight: each answered, ``tpuserve_acceptor_worker_up`` 0 then 1,
    ``restarts_total`` 1, and after the respawn check 1's frames byte-equal;
    a demoted model answers 503 ``cold_start`` on the fast lane, and the
    loop lag over its restore's captures is printed; (6) ``/admin/perf``:
    each stage of check 1's traffic with one row a model and the count of
    requests each lane sent, loop lag, the dispatch thread in the stack
    table, BERT's gauges with ``mfu_pct`` its own arithmetic against the
    card's peak, ``cli perf`` rendering it; (7) ``/metrics`` with the host
    planes' families against the manifest."""
    import os
    import platform

    from pytorch_zappa_serverless_tpu_torch.ops import counters
    from pytorch_zappa_serverless_tpu_torch.serving import wire
    from pytorch_zappa_serverless_tpu_torch.serving.perfplane import (CHIP_PEAK_FLOPS,
                                                                      hist_quantile)
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    cuda = torch.device(device).type == "cuda"
    tensor = {"Content-Type": wire.TENSOR_CONTENT_TYPE}
    rng = np.random.default_rng(20)
    pngs = vision_pngs(8, seed=20)
    bert = "/v1/models/bert_base:predict"
    resnet = "/v1/models/resnet50:predict"
    out: dict = {"machine": platform.machine(), "launches": 0, "forwards": 0, "p50": {},
                 "p99": {}}
    t0 = time.perf_counter()
    with BackgroundServer(cfg, device=device) as srv:
        port, server = srv.port, srv.server
        sup = server.acceptors
        fast = sup.ingest_port
        out["spawn_s"] = list(sup.spawn_seconds)
        cm_resnet = server.engine.model("resnet50")
        pixels = [cm_resnet.servable.preprocess(png)["image"] for png in pngs]
        ids = [rng.integers(1, bert_vocab - 1, int(n)).tolist()
               for n in rng.integers(4, BERT["seq"] + 1, INGEST_SINGLES + 8 * INGEST_EIGHTS)]
        items = {"bert_base": [{"input_ids": x} for x in ids],
                 "resnet50": [pixels[i % len(pixels)] for i in range(len(ids))]}
        frames = {name: [bytes(wire.pack(its[i:i + 1])) for i in range(INGEST_SINGLES)]
                  + [bytes(wire.pack(its[INGEST_SINGLES + 8 * j: INGEST_SINGLES + 8 * j + 8],
                                     flags=wire.FLAG_LIST)) for j in range(INGEST_EIGHTS)]
                  for name, its in items.items()}
        paths = {"bert_base": bert, "resnet50": resnet}

        def send(p, name, frame, headers=None):
            status, raw, h = http_b(p, paths[name], frame, {**tensor, **(headers or {})})
            check(status == 200 and h.get("Content-Type") == wire.TENSOR_CONTENT_TYPE,
                  f"{name} on port {p}: {status} {raw[:300]}")
            check(h.get("X-Request-Id") and h.get("X-Trace-Id"), f"{name}: answer ids {h}")
            return wire.unpack_response(raw)[1]

        def fast_segment(fn):
            """Fast-lane traffic alone, its int8_matmul launches and BERT
            forwards counted: launches = per_forward x forwards, all in
            replays."""
            def forwards():
                st = server.engine.runner.stats.get("bert_base")
                return st.batches if st is not None else 0

            reset_counts()
            before = forwards()
            res = fn()
            counts, graphed = read_counts(), counters.graphed()
            fwd = forwards() - before
            check(not cuda or (counts["int8_matmul"] == per_forward * fwd > 0
                               and graphed["int8_matmul"] == counts["int8_matmul"]),
                  f"fast lane: int8_matmul {counts['int8_matmul']} launches "
                  f"({graphed['int8_matmul']} in replays) for {fwd} BERT forwards")
            out["launches"] += counts["int8_matmul"]
            out["forwards"] += fwd
            return res

        def perf():
            return http_h(port, "/admin/perf?top=50")[1]

        lag = server.perf.loop_lag

        def lag_max_over(fn):
            """The loop lag's max over ``fn`` alone (the lifetime max kept)."""
            saved = srv.call(lambda: lag.max_ms)
            srv.call(setattr, lag, "max_ms", 0.0)
            res = fn()
            time.sleep(2 * lag.interval_s)
            over = srv.call(lambda: lag.max_ms)
            srv.call(setattr, lag, "max_ms", max(saved, over))
            return res, over

        # -- check 1: the fast lane against the main port's binary lane -------------
        # The loop lag's max from the plane's start to here: the boot and the
        # client's host work in this process (its preprocess of the PNGs).
        out["pre_traffic_lag_max_ms"] = srv.call(lambda: lag.max_ms)
        before = perf()["ingest"]
        got, out["traffic_lag_max_ms"] = lag_max_over(lambda: fast_segment(
            lambda: {n: [send(fast, n, f) for f in fs] for n, fs in frames.items()}))
        want = {n: [send(port, n, f) for f in fs] for n, fs in frames.items()}
        after = perf()["ingest"]
        for name in frames:
            check(json.dumps(got[name]) == json.dumps(want[name]),
                  f"{name}: fast-lane answers differ from the main port's binary lane")
        n = len(frames["bert_base"])
        for name in frames:
            for stage in set(FAST_STAGES) | set(MAIN_STAGES):
                sent = n * ((stage in FAST_STAGES) + (stage in MAIN_STAGES))
                delta = (after.get(name, {}).get(stage, {"count": 0})["count"]
                         - before.get(name, {}).get(stage, {"count": 0})["count"])
                check(delta == sent, f"/admin/perf {name} {stage}: {delta} rows for {sent} "
                                     "requests")
        out["stages"] = {name: {s: hist_quantile(after[name][s], 0.5)
                                for s in after[name]} for name in frames}
        oversize = (wire._HDR.pack(wire.MAGIC, wire.VERSION, 0, 1) + wire._BLK.pack(9, 2, 0)
                    + wire._DIM.pack(60000) + wire._DIM.pack(60000))
        errors = {}
        for what, path, body, hdrs, status_want in (
                ("oversize", resnet, oversize, tensor, 413),
                ("truncated", resnet, frames["resnet50"][0][:-100], tensor, 400),
                ("json", bert, json.dumps({"input_ids": ids[0]}).encode(),
                 {"Content-Type": "application/json"}, 415)):
            status, raw, h = http_b(fast, path, body, {**hdrs, "X-Request-Id": f"ing-{what}"})
            body = json.loads(raw)
            check(status == status_want and body["request_id"] == f"ing-{what}"
                  == h["X-Request-Id"] and body["trace_id"] == h["X-Trace-Id"],
                  f"fast lane {what}: {status} {body} {h}")
            errors[what] = status
        http_h(port, "/admin/faults", {"model": "bert_base", "latency_ms": INGEST_SLOW_MS})
        try:
            slow = threading.Thread(target=http_b, args=(fast, bert, frames["bert_base"][0],
                                                         tensor))
            slow.start()
            time.sleep(0.05)
            status, raw, h = http_b(fast, bert, frames["bert_base"][1],
                                    {**tensor, "X-Deadline-MS": "1"})
            slow.join(60)
        finally:
            http_h(port, "/admin/faults", {"clear": True})
        body = json.loads(raw)
        check(status == 504 and body["request_id"] == h["X-Request-Id"]
              and body["trace_id"] == h["X-Trace-Id"], f"deadline: {status} {body} {h}")
        errors["deadline"] = status
        log(f"ingest check 1: fast-lane answers equal to the main port's binary lane "
            f"(BERT int8 and ResNet-50 bf16, {INGEST_SINGLES} singles and {INGEST_EIGHTS} "
            f"8-instance frames each); at the worker {errors}, each with both ids; loop lag "
            f"max over the fast-lane traffic {out['traffic_lag_max_ms']:.3f} ms, before it "
            f"{out['pre_traffic_lag_max_ms']:.3f} ms")
        # -- check 2: the launches -----------------------------------------------
        log(f"ingest check 2: int8_matmul {out['launches']} launches on the fast lane = "
            f"{per_forward} x {out['forwards']} BERT forwards, every one in a replay")
        # -- check 3: the workers ------------------------------------------------
        check(sup.alive_workers() == INGEST_WORKERS, f"{sup.alive_workers()} workers alive")
        accepts = [blk.snapshot()["accepts"] for blk in sup.stats_blocks]
        check(all(a > 0 for a in accepts), f"requests reached only some workers: {accepts}")
        for p in sup.workers:
            with open(f"/proc/{p.pid}/maps") as f:
                check("libtorch" not in f.read(), f"acceptor worker {p.pid} maps libtorch")
        health = http_h(fast, "/healthz")[1]
        check(health["torch_loaded"] is False, f"a worker loaded torch: {health}")
        log(f"ingest check 3: {sup.alive_workers()} workers alive, accepts {accepts}, no "
            f"worker maps libtorch")
        # -- check 4: one trace from the worker's accept to the answer -------------
        tid, sid = "20" * 16, "0123456789abcdef"
        fast_segment(lambda: send(fast, "bert_base", frames["bert_base"][2],
                                  {"traceparent": f"00-{tid}-{sid}-01"}))
        tree = http_h(port, f"/admin/trace/{tid}")[1]["trace"]
        check(tree["remote_parent"] == sid and tree["status"] == "ok", f"trace {tree}")
        kids = {c["name"]: c for c in tree["tree"]["children"]}
        chain = ["sock_read", "frame_validate", "ring_wait", "binary_decode", "admission",
                 "queue", "batch_form", "device", "respond"]
        check(all(s in kids for s in chain), f"the fast-lane trace lacks {set(chain) - set(kids)}")
        starts = [kids[s]["start_ms"] for s in chain if s != "admission"]
        check(starts == sorted(starts),
              f"the chain out of order: {[(s, kids[s]['start_ms']) for s in chain]}")
        check(find_span(kids["device"], "exec") is not None,
              f"no exec under device: {kids['device']}")
        out["trace"] = {s: kids[s]["duration_ms"] for s in chain}
        log(f"ingest check 4: the traceparent joined; chain ms {out['trace']}")
        # -- check 5: kill -9 of a worker, then a demoted model --------------------
        http_h(port, "/admin/faults", {"model": "bert_base", "latency_ms": INGEST_SLOW_MS})
        results: list = [None] * INGEST_INFLIGHT

        def inflight(i):
            try:
                results[i] = http_b(fast, bert, frames["bert_base"][i], tensor, timeout=60)[0]
            except Exception as e:  # noqa: BLE001 — the connection died with its worker
                results[i] = type(e).__name__

        threads = [threading.Thread(target=inflight, args=(i,)) for i in range(INGEST_INFLIGHT)]

        def kill_and_respawn():
            for th in threads:
                th.start()
            time.sleep(0.1)
            os.kill(sup.workers[0].pid, 9)
            t = time.perf_counter()
            down = False
            while time.perf_counter() - t < 10:
                rows = srv.call(sup.telemetry_snapshot)["workers"]
                down = down or not rows[0]["up"]
                if down and rows[0]["up"]:
                    break
                time.sleep(0.01)
            for th in threads:
                th.join(60)
            return t, down

        try:
            (t_kill, seen_down), out["respawn_lag_max_ms"] = lag_max_over(kill_and_respawn)
        finally:
            http_h(port, "/admin/faults", {"clear": True})
        out["respawn_start_ms"] = sup.workers[0].start_ms
        check(all(r is not None for r in results), f"in-flight requests unanswered: {results}")
        check(seen_down and sup.restarts == 1, f"worker_up never 0 ({seen_down}) or restarts "
                                               f"{sup.restarts}")
        wait_until(lambda: sup.alive_workers() == INGEST_WORKERS and all(
            r["up"] and r["heartbeat_age_s"] is not None
            for r in srv.call(sup.telemetry_snapshot)["workers"]), 60, "the respawn to serve")
        respawn_s = time.perf_counter() - t_kill
        again = fast_segment(lambda: [send(fast, n, f) for n in ("bert_base", "resnet50")
                                      for f in frames[n][:4]])
        check(json.dumps(again) == json.dumps(got["bert_base"][:4] + got["resnet50"][:4]),
              "after the respawn the fast lane answers other bytes")
        _, prom_kill, _ = http_h(port, "/metrics?format=prometheus")
        check("tpuserve_acceptor_restarts_total 1" in prom_kill
              and 'tpuserve_acceptor_worker_up{worker="0"} 1' in prom_kill,
              "restarts_total / worker_up after the respawn")
        log(f"ingest check 5: kill -9 of worker 0 with {INGEST_INFLIGHT} requests in flight: "
            f"answers {results}; worker_up 0 then 1, restarts_total 1, serving again "
            f"{respawn_s:.3f} s after the kill; 8 frames byte-equal to check 1's; the "
            f"respawn's start held the loop {out['respawn_start_ms']:.3f} ms, loop lag max "
            f"over the kill and respawn {out['respawn_lag_max_ms']:.3f} ms")
        status, o, _ = http_h(port, "/admin/models/resnet50", {"action": "demote", "to": "host"})
        check(status == 200, f"demote: {status} {o}")
        status, raw, h = http_b(fast, resnet, frames["resnet50"][0], tensor)
        body = json.loads(raw)
        check(status == 503 and body.get("cold_start") and int(h["Retry-After"]) >= 1,
              f"a demoted model on the fast lane: {status} {body}")
        ta = time.perf_counter()
        _, out["restore_lag_max_ms"] = lag_max_over(lambda: wait_until(
            lambda: server.lifecycle.state_of("resnet50") == "active", 120,
            "the fast lane's activation of resnet50"))
        out["restore_ms"] = (time.perf_counter() - ta) * 1e3
        check(json.dumps(send(fast, "resnet50", frames["resnet50"][0]))
              == json.dumps(got["resnet50"][0]), "resnet50 after its restore answers other bytes")
        log(f"ingest check 5b: a demoted resnet50 answered the fast lane 503 cold_start "
            f"(Retry-After {h['Retry-After']}); its activation (host tier, captures) "
            f"{out['restore_ms']:.1f} ms; event-loop lag max over it "
            f"{out['restore_lag_max_ms']:.3f} ms; answers byte-equal after")
        # The client p50 and p99, fast lane against the main port's binary lane.
        for name in frames:
            for lane, p in (("fast", fast), ("main", port)):
                times = []
                for _ in range(reqs):
                    t = time.perf_counter()
                    status, _, _ = http_b(p, paths[name], frames[name][3], tensor)
                    times.append((time.perf_counter() - t) * 1e3)
                    check(status == 200, f"{name} {lane} p50 request: {status}")
                out["p50"][f"{name} {lane}"] = statistics.median(times)
                out["p99"][f"{name} {lane}"] = float(np.percentile(times, 99))
        # -- check 6: /admin/perf ------------------------------------------------
        r, out["generate_lag_max_ms"] = lag_max_over(lambda: sse(
            port, "gpt2", {"input_ids": rng.integers(0, gpt2_vocab - 1, 12).tolist()}))
        check(r["status"] == 200 and r["final"] and r["final"]["done"], f"gpt2 stream {r}")
        time.sleep(3 * cfg.perf_loop_lag_interval_s)
        snap = perf()
        gen_row = snap["models"].get("gpt2:generate", {})
        check("tokens_per_s" in gen_row and "ttft_p50_ms" in gen_row,
              f"the :generate lane's gauges: {gen_row}")
        lag_hist = snap["loop_lag"]["hist"]
        check(lag_hist["count"] > 0, f"empty loop-lag histogram: {snap['loop_lag']}")
        check(any(r["stack"].startswith("cuda-dispatch;") for r in snap["stacks"]["stacks"]),
              f"the stack table names no dispatch thread: "
              f"{[r['stack'][:40] for r in snap['stacks']['stacks']]}")
        row = snap["models"].get("bert_base", {})
        for key in ("samples_per_s", "step_ms", "device_util_pct"):
            check(key in row, f"bert_base gauges lack {key}: {row}")
        peak = CHIP_PEAK_FLOPS.get(torch.cuda.get_device_name(0)) if cuda else None
        flops = cfg.model("bert_base").extra["flops_per_sample"]
        if peak is not None:
            mfu = 100.0 * flops * row["samples_per_s"] / peak
            check(0 < row.get("mfu_pct", 0) <= 100
                  and abs(row["mfu_pct"] - mfu) <= 0.011 + 0.005 * mfu,
                  f"mfu_pct {row.get('mfu_pct')} against its own arithmetic {mfu}")
        else:
            check("mfu_pct" not in row, f"an MFU gauge with no peak: {row}")
        out["gauges"] = row
        out["lag"] = {"p50": hist_quantile(lag_hist, 0.5), "max": snap["loop_lag"]["max_ms"],
                      "ticks": snap["loop_lag"]["ticks"]}
        table = subprocess.run([sys.executable, "-m", "pytorch_zappa_serverless_tpu_torch.cli",
                                "perf", "--url", f"http://127.0.0.1:{port}"],
                               capture_output=True, text=True, timeout=60)
        check(table.returncode == 0 and "loop lag:" in table.stdout
              and "sock_read" in table.stdout, f"cli perf: {table.returncode} "
                                               f"{table.stdout[:300]} {table.stderr[-300:]}")
        out["gen_gauges"] = gen_row
        log(f"ingest check 6a: the first :generate stream (its lane's graphs captured at "
            f"first use): loop lag max over it {out['generate_lag_max_ms']:.3f} ms")
        log(f"ingest check 6: /admin/perf: every stage of check 1 counted per model and lane; "
            f"loop lag p50 {out['lag']['p50']} ms, max {out['lag']['max']} ms over "
            f"{out['lag']['ticks']} ticks; bert_base {row}; gpt2:generate {gen_row}; peak "
            f"{peak}; cli perf renders {len(table.stdout.splitlines())} lines")
        # -- check 7: the exposition ---------------------------------------------
        _, metrics, _ = http_h(port, "/metrics?format=prometheus")
        out["spawn_s"] = list(sup.spawn_seconds)
    check_metrics = check_metrics_tool()
    problems = check_metrics.check(metrics, check_metrics.load_manifest())
    check(not problems, f"/metrics against the manifest: {problems}")
    missing = [f for f in HOST_FAMILIES if f"# TYPE {f} " not in metrics]
    check(not missing or (not cuda and missing == ["tpuserve_perf_mfu_pct"]),
          f"/metrics lacks {missing}")
    log(f"ingest check 7: /metrics with the host planes' {len(HOST_FAMILIES)} families "
        f"against the manifest")
    out["seconds"] = time.perf_counter() - t0
    return out


def run_ingest(card: str) -> dict:
    """Phase 20: the host ingest planes on the card."""
    import platform

    fresh_memory()
    t0 = time.perf_counter()
    slots, slot_bytes, shm = ring_geometry()
    log(f"{card}: ingest: host {platform.machine()}, /dev/shm {shm}; rings "
        f"{slots} x {slot_bytes} bytes, {INGEST_WORKERS} workers")
    run = phase_ingest_path(ingest_config(slots=slots, slot_bytes=slot_bytes))
    log(f"{card}: ingest client ms, {INGEST_REQS} sequential single requests a model and lane: "
        + ", ".join(f"{k} p50 {run['p50'][k]:.3f} p99 {run['p99'][k]:.3f}" for k in run["p50"]))
    for name, stages in run["stages"].items():
        log(f"{card}: ingest stage p50 ms {name}: "
            + ", ".join(f"{s} {v}" for s, v in stages.items()))
    log(f"{card}: ingest: loop lag p50 {run['lag']['p50']} ms, max {run['lag']['max']} ms; "
        f"worker spawn s {run['spawn_s']}; phase 20 in {time.perf_counter() - t0:.3f} s; "
        f"int8_matmul {run['launches']} launches on the fast lane")
    return run


# -- phase 21: the fleet router on the card ------------------------------------

FLEET_POLL_S = 0.4          # the router's poll interval (2 missed polls quarantine)
FLEET_PREDICTS = 16         # BERT predicts routed and direct, check 1
FLEET_STREAMS = 4           # GPT-2 streams routed and direct, check 1
FLEET_TIMING_REQS = 100     # sequential single predicts routed and direct, the overhead
FLEET_NEW = 32              # new tokens a check-1 stream
FLEET_JOBS = 6              # acknowledged :submit jobs at the kill, check 3
FLEET_SLOW_MS = 600.0       # the latency of check 3's replica rule, and slow_replica's
FLEET_RAISE_MS = 20.0       # the replica rule that raises r0's forecast, check 2
FLEET_CONCURRENT = 8        # predicts under slow_replica, check 2
FLEET_BOOT_S = 300.0


def fleet_config(workdir: str, bert_arch: dict | None = None, gpt2_arch: dict | None = None,
                 gpt2_extra: dict | None = None, bert_extra: dict | None = None) -> dict:
    """The replicas' profile (JSON: no PyYAML on the card's machine):
    ``bert_int8`` (BERT-base int8, (1, 8) x 128, warm at boot) and ``gpt2``
    (GPT-2 small int8 on the paged lane, 16-token pages, 8 slots), the
    journal on, seed weights at full width; the router's knobs beside."""
    return {"host": "127.0.0.1", "port": 8000, "warmup_at_boot": True,
            "journal_dir": f"{workdir}/journal", "journal_fsync": "always",
            "job_max_backlog": 64, "drain_timeout_s": 10.0, "trace_dir": f"{workdir}/traces",
            "fleet": {"poll_interval_s": FLEET_POLL_S, "connect_timeout_s": 1.0,
                      "quarantine_after": 2, "failover_retries": 1, "breaker_threshold": 0.5,
                      "breaker_min_samples": 4},
            "models": [
                {"name": "bert_int8", "builder": "bert_base", "dtype": "bfloat16",
                 "batch_buckets": list(PLANE_BERT), "seq_buckets": [BERT["seq"]],
                 "coalesce_ms": 0.0,
                 "extra": {"params_dtype": "int8", **(bert_extra or {}),
                           **({"arch": bert_arch} if bert_arch else {})}},
                {"name": "gpt2", "dtype": "bfloat16", "batch_buckets": [1],
                 "seq_buckets": [16, 64], "kv_cache": "paged", "kv_block_size": 16,
                 "prefill_chunk_tokens": 64,
                 "extra": {"params_dtype": "int8", "gen_slots": 8, "segment_tokens": 8,
                           "max_new_tokens": FLEET_NEW, **(gpt2_extra or {}),
                           **({"arch": gpt2_arch} if gpt2_arch else {})}}]}


def _fleet_state(router: int, rid: str) -> dict:
    _, fleet, _ = http_h(router, "/admin/fleet", timeout=10.0)
    return fleet["replicas"].get(rid, {})


def _wait_state(router: int, rid: str, want: set, timeout_s: float) -> float:
    """Seconds until replica ``rid`` is in ``want`` on the router."""
    t0 = time.monotonic()
    last = None
    while time.monotonic() - t0 < timeout_s:
        try:
            last = _fleet_state(router, rid).get("state")
            if last in want:
                return time.monotonic() - t0
        except (OSError, ValueError, KeyError):
            pass
        time.sleep(0.02)
    raise AssertionError(f"replica {rid} never reached {want} (last {last}) in {timeout_s} s")


def _wait_up(port: int, timeout_s: float, proc=None) -> float:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"the process on :{port} exited with {proc.returncode}")
        try:
            if http_b(port, "/", None, method="GET", timeout=2.0)[0] == 200:
                return time.monotonic() - t0
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"nothing answered on :{port} within {timeout_s} s")


def _int8(port: int) -> int:
    _, m, _ = http_h(port, "/metrics", headers={"Accept": "application/json"})
    return int(m.get("kernels", {}).get("int8_matmul", 0))


def _restart_replica(cfg_path: str, port: int, journal: str, log_path: str, platform: str):
    """One ``cli serve`` on a replica's port and journal (a restart)."""
    import os

    env = {**os.environ, "TPUSERVE_PORT": str(port), "TPUSERVE_JOURNAL_DIR": journal}
    with open(log_path, "ab") as logf:
        return subprocess.Popen([sys.executable, "-m", "pytorch_zappa_serverless_tpu_torch.cli",
                                 "serve", "--config", cfg_path, "--platform", platform],
                                env=env, stdout=logf, stderr=logf)


def phase_fleet_path(card: str, workdir: str, platform: str = "cuda", bert_vocab: int = 30522,
                     gpt2_vocab: int = 50257, per_forward: int = 72, **cfg_kw) -> dict:
    """Phase 21 checks 1-2 on one ``cli fleet --spawn 2`` router and its two
    replicas.  (1) Routing: both replicas healthy; BERT predicts and GPT-2
    streams through the router equal to the same requests sent to the
    replica directly, the int8 launches of the predicts exactly their
    forwards'; a routed request's trace on the replica under the router's
    span; the router's Prometheus text against the manifest; the router's
    overhead.  (2) Chaos: a partition fails over within one retry,
    quarantines and readmits; under slow_replica the picks follow the least
    forecast wait, with the forecasts made to differ; a cold_start spill
    activates a cold GPT-2 in the background while the replica stays
    routable; drain stops routing, undrain after a restart restores it."""
    from pytorch_zappa_serverless_tpu_torch.tools import warm_probe
    from pytorch_zappa_serverless_tpu_torch.tools.crashtest import _free_port, free_port_run

    t_phase = time.perf_counter()
    router = _free_port()
    base_port = free_port_run(2, avoid=(router,))
    cfg = fleet_config(workdir, **cfg_kw)
    cfg["fleet"]["spawn_base_port"] = base_port
    cfg_path = f"{workdir}/fleet.json"
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    ports = {"r0": base_port, "r1": base_port + 1}
    journals = {rid: f"{workdir}/journal/replica-{i}" for i, rid in enumerate(ports)}
    out: dict = {"launches": {}, "boot_s": {}}
    restarted: list = []
    t0 = time.monotonic()
    with open(f"{workdir}/fleet.log", "ab") as logf:
        fleet = subprocess.Popen([sys.executable, "-m", "pytorch_zappa_serverless_tpu_torch.cli",
                                  "fleet", "--config", cfg_path, "--spawn", "2", "--port",
                                  str(router), "--platform", platform],
                                 stdout=logf, stderr=logf)
    try:
        for rid, port in ports.items():  # from the fleet's start
            _wait_up(port, FLEET_BOOT_S, fleet)
            out["boot_s"][rid] = round(time.monotonic() - t0, 3)
        _wait_up(router, 60.0, fleet)
        for rid in ports:
            _wait_state(router, rid, {"healthy"}, 60.0)
        out["fleet_ready_s"] = round(time.monotonic() - t0, 3)
        mem = {}
        for rid, port in ports.items():
            _, snap, _ = http_h(port, "/admin/models")
            mem[rid] = round(snap["hbm_bytes_total"] / 2**20, 1)
        log(f"{card}: fleet: cli fleet --spawn 2 ready in {out['fleet_ready_s']} s; replica "
            f"boot s {out['boot_s']}; device MiB (model and KV ledger) {mem}")
        rng = np.random.default_rng(21)
        # -- check 1: routing ------------------------------------------------
        before = {rid: _int8(p) for rid, p in ports.items()}
        bodies = [{"input_ids": [101, *rng.integers(min(1000, bert_vocab // 2), bert_vocab - 1,
                                                    40).tolist(), 102]}
                  for _ in range(FLEET_PREDICTS)]
        for body in bodies:
            st, routed, hdrs = http_h(router, "/v1/models/bert_int8:predict", body)
            check(st == 200 and hdrs.get("X-Fleet-Attempts") == "1",
                  f"routed predict: {st} {routed} {hdrs}")
            st, direct, _ = http_h(ports[hdrs["X-Fleet-Replica"]],
                                   "/v1/models/bert_int8:predict", body)
            check(st == 200 and routed["predictions"] == direct["predictions"],
                  f"routed predictions differ from direct: {routed} {direct}")
        launched = sum(_int8(p) - before[rid] for rid, p in ports.items())
        check(launched == per_forward * 2 * FLEET_PREDICTS,
              f"int8_matmul {launched} launches for {2 * FLEET_PREDICTS} forwards, want "
              f"{per_forward} each")
        tp = "00-" + "5a" * 16 + "-" + "c3" * 8 + "-01"
        st, _, hdrs = http_h(router, "/v1/models/bert_int8:predict", bodies[0],
                             {"traceparent": tp})
        check(hdrs.get("X-Trace-Id") == "5a" * 16, f"routed trace id {hdrs.get('X-Trace-Id')}")
        st, tr, _ = http_h(ports[hdrs["X-Fleet-Replica"]], f"/admin/trace/{'5a' * 16}")
        tree = tr.get("trace", {})
        check(st == 200 and tree.get("remote_parent") not in (None, "c3" * 8)
              and tree["tree"]["name"] == "predict" and tree["spans"] >= 4,
              f"the replica's trace is not under the router's span: {st} {tree}")
        gen_bodies = [{"input_ids": rng.integers(100, gpt2_vocab - 2, 12 + 3 * i).tolist(),
                       "max_new_tokens": FLEET_NEW} for i in range(FLEET_STREAMS)]
        for body in gen_bodies:
            # Direct to the other replica: the same prompt again on the one
            # that served it would hit its prefix cache and prefill by
            # other chunks (a rounding apart at a near-tie).
            routed = sse(router, "gpt2", body)
            check(routed["status"] == 200 and routed["final"].get("done"),
                  f"routed stream: {routed}")
            other = "r1" if routed["headers"]["X-Fleet-Replica"] == "r0" else "r0"
            direct = sse(ports[other], "gpt2", body)
            check(routed["tokens"] == direct["tokens"] == routed["final"]["tokens"]
                  == direct["final"]["tokens"],
                  f"routed stream differs from direct: {routed['tokens']} {direct['tokens']}")
        timing = {"routed": [], "direct": []}
        for i in range(FLEET_TIMING_REQS):
            for lane, port in (("routed", router), ("direct", ports["r0"])):
                t = time.perf_counter()
                st, _, _ = http_h(port, "/v1/models/bert_int8:predict",
                                  bodies[i % len(bodies)])
                timing[lane].append((time.perf_counter() - t) * 1e3)
                check(st == 200, f"timing predict {lane}: {st}")
        _, m, _ = http_h(router, "/metrics")
        from pytorch_zappa_serverless_tpu_torch.serving.perfplane import hist_quantile

        rms = m["fleet"]["router_ms"]["bert_int8"]
        out["overhead"] = {lane: {"p50": float(np.percentile(v, 50)),
                                  "p99": float(np.percentile(v, 99))}
                           for lane, v in timing.items()}
        out["router_ms"] = {"count": rms["count"], "mean": rms["sum"] / rms["count"],
                            "p50": hist_quantile(rms, 0.5), "p99": hist_quantile(rms, 0.99)}
        log(f"{card}: fleet: {FLEET_TIMING_REQS} sequential BERT int8 predicts (bucket 1) "
            f"routed: client p50 {out['overhead']['routed']['p50']:.3f} ms, p99 "
            f"{out['overhead']['routed']['p99']:.3f} ms; direct: p50 "
            f"{out['overhead']['direct']['p50']:.3f} ms, p99 "
            f"{out['overhead']['direct']['p99']:.3f} ms; tpuserve_fleet_router_ms over "
            f"{rms['count']}: mean {out['router_ms']['mean']:.3f} ms, p50 "
            f"{out['router_ms']['p50']} ms, p99 {out['router_ms']['p99']} ms (bucketed)")
        # -- check 2: chaos ----------------------------------------------------
        # Partition the replica the router picks now, so the next predict
        # meets the partition first.
        st, _, hdrs = http_h(router, "/v1/models/bert_int8:predict", bodies[0])
        cut = hdrs["X-Fleet-Replica"]
        peer = "r1" if cut == "r0" else "r0"
        st, _, _ = http_h(router, "/admin/fleet/faults",
                          {"replica": cut, "kind": "partition"})
        check(st == 200, "partition fault refused")
        t = time.monotonic()
        st, body, hdrs = http_h(router, "/v1/models/bert_int8:predict", bodies[0])
        first_peer_ms = (time.monotonic() - t) * 1e3
        check(st == 200 and hdrs["X-Fleet-Replica"] == peer and hdrs["X-Fleet-Attempts"] == "2",
              f"partitioned {cut}: {st} {hdrs}")
        out["quarantine_s"] = round(_wait_state(router, cut, {"quarantined"}, 10.0), 3)
        st, _, hdrs = http_h(router, "/v1/models/bert_int8:predict", bodies[1])
        check(st == 200 and hdrs["X-Fleet-Attempts"] == "1" and hdrs["X-Fleet-Replica"] == peer,
              f"quarantined {cut} still picked: {hdrs}")
        http_h(router, "/admin/fleet/faults", {"clear": True})
        out["readmit_s"] = round(_wait_state(router, cut, {"healthy"}, 10.0), 3)
        _, fm, _ = http_h(router, "/admin/fleet")
        check(fm["metrics"]["failovers"].get("connect", 0) >= 1, f"failovers {fm['metrics']}")
        out["first_peer_ms"] = first_peer_ms
        log(f"{card}: fleet: partition of {cut}: first answer from {peer} after "
            f"{first_peer_ms:.3f} ms (2 attempts); quarantined after {out['quarantine_s']} s; "
            f"readmitted {out['readmit_s']} s after the partition cleared (polls every "
            f"{FLEET_POLL_S} s)")
        # slow_replica: a router-side brownout that the replicas' forecasts
        # do not see.  First r0's forecast is raised: a replica-side latency
        # rule on r0 while more predicts than it has served go to it
        # directly, so its p50 device time (an empty queue's forecast) is
        # the rule's.  Then slow_replica on r1: the least forecast wait
        # sends every pick to r1, where the id alone would pick r0, and
        # r1's answers come FLEET_SLOW_MS late.
        _, m0, _ = http_h(ports["r0"], "/metrics", headers={"Accept": "application/json"})
        served = int(m0["models"]["bert_int8"]["requests"])
        st, _, _ = http_h(ports["r0"], "/admin/faults",
                          {"model": "bert_int8", "latency_ms": FLEET_RAISE_MS})
        check(st == 200, "latency fault on r0 refused")
        with ThreadPoolExecutor(8) as pool:
            sts = list(pool.map(lambda b: http_h(ports["r0"], "/v1/models/bert_int8:predict",
                                                 b)[0],
                                [bodies[i % len(bodies)] for i in range(served + 16)]))
        check(set(sts) == {200}, f"r0's slowed predicts: {sorted(set(sts))}")
        http_h(ports["r0"], "/admin/faults", {"clear": True, "model": "bert_int8"})
        deadline = time.monotonic() + 5
        while True:
            reps = http_h(router, "/admin/fleet")[1]["replicas"]
            fc = {rid: reps[rid]["forecast"].get("bert_int8", 0.0) for rid in ports}
            if fc["r0"] >= FLEET_RAISE_MS / 2 and fc["r0"] > 2 * fc["r1"]:
                break
            check(time.monotonic() < deadline, f"r0's forecast never rose on the router: {fc}")
            time.sleep(0.05)
        http_h(router, "/admin/fleet/faults",
               {"replica": "r1", "kind": "slow_replica", "latency_ms": FLEET_SLOW_MS})
        rows = []
        for b in bodies[:FLEET_CONCURRENT]:
            t = time.monotonic()
            st, _, hdrs = http_h(router, "/v1/models/bert_int8:predict", b)
            ms = (time.monotonic() - t) * 1e3
            rows.append((hdrs.get("X-Fleet-Replica"), round(ms, 1)))
            check(st == 200 and hdrs["X-Fleet-Replica"] == "r1" and ms >= FLEET_SLOW_MS,
                  f"slow_replica r1 with r0's forecast {fc['r0']} ms against r1's "
                  f"{fc['r1']} ms: {st} {rows}")
        http_h(router, "/admin/fleet/faults", {"clear": True})
        log(f"{card}: fleet: forecasts on the router r0 {fc['r0']} ms (raised by a "
            f"{FLEET_RAISE_MS:.0f} ms rule over {served + 16} predicts), r1 {fc['r1']} ms; "
            f"slow_replica r1 (+{FLEET_SLOW_MS:.0f} ms a forward): {FLEET_CONCURRENT} of "
            f"{FLEET_CONCURRENT} picks went to r1, the least forecast wait; (replica, client "
            f"ms) {rows}")
        # The warm-up probe: a cold GPT-2 activated in the background on r1
        # while the router watches it.
        st, body, _ = http_h(ports["r1"], "/admin/models/gpt2", {"action": "unload"})
        check(st == 200 and body["model"]["state"] == "cold", f"unload gpt2 on r1: {st} {body}")
        http_h(router, "/admin/fleet", {"action": "quarantine", "replica": "r0"})
        deadline = time.monotonic() + 5
        while _fleet_state(router, "r1")["residency"]["gpt2"]["state"] != "cold":
            check(time.monotonic() < deadline, "the router never saw r1's gpt2 cold")
            time.sleep(0.05)
        probe = warm_probe.spill_and_watch(f"http://127.0.0.1:{router}",
                                           f"http://127.0.0.1:{ports['r1']}")
        out["activation_ms"], out["probe_states"] = probe["activation_ms"], probe["states"]
        log(f"{card}: fleet: warm-up probe: r1's cold gpt2 activated in the background by the "
            f"spill in {probe['activation_ms']} ms; r1's states on the router across it "
            f"{probe['states']} ({probe['reads']} reads, max consecutive poll failures "
            f"{probe['max_consecutive_failures']}); /healthz named holds {probe['holds_named']}")
        check(probe["spill"] == [503, "all_cold"] and probe["active"],
              f"the cold spill and its activation: {probe}")
        check(probe["states"] == ["healthy"], f"r1 left routing while it activated: {probe}")
        check(probe["holds_named"] or probe["activation_ms"] < 1000.0,
              "/healthz never named the hold during the activation")
        http_h(router, "/admin/fleet", {"action": "readmit", "replica": "r0"})
        out["launches"]["fleet_r0_before_drain"] = _int8(ports["r0"])
        st, body, _ = http_h(router, "/admin/fleet",
                             {"action": "drain", "replica": "r0", "timeout_s": 5.0})
        check(st == 200 and body.get("terminated") is True, f"drain r0: {st} {body}")
        deadline = time.monotonic() + 60
        while True:  # the drained process exits; then its port is free again
            try:
                http_b(ports["r0"], "/", None, method="GET", timeout=1.0)
            except OSError:
                break
            check(time.monotonic() < deadline, "the drained r0 never exited")
            time.sleep(0.1)
        r0b = _restart_replica(cfg_path, ports["r0"], journals["r0"],
                               f"{workdir}/r0-restart.log", platform)
        restarted.append(r0b)
        for body in bodies[:3]:
            st, _, hdrs = http_h(router, "/v1/models/bert_int8:predict", body)
            check(st == 200 and hdrs["X-Fleet-Replica"] == "r1", f"drained r0 routed: {hdrs}")
        out["boot_s"]["r0-restart"] = round(_wait_up(ports["r0"], FLEET_BOOT_S, r0b), 3)
        st, body, _ = http_h(router, "/admin/fleet", {"action": "undrain",
                                                             "replica": "r0"})
        check(st == 200, f"undrain r0: {st} {body}")
        _wait_state(router, "r0", {"healthy"}, 30.0)
        log(f"{card}: fleet: drain of r0 stopped its routing and terminated it; restarted in "
            f"{out['boot_s']['r0-restart']} s and undrained, r0 healthy again")
        text = http_b(router, "/metrics?format=prometheus", None, method="GET")[1].decode()
        mod = check_metrics_tool()
        problems = mod.check(text, mod.load_manifest())
        check(problems == [], f"router metrics against the manifest: {problems}")
        fams = sorted({ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")})
        out["families"] = len(fams)
        out["launches"]["fleet_r0_restart"] = _int8(ports["r0"])
        out["launches"]["fleet_r1"] = _int8(ports["r1"])
        out["seconds"] = time.perf_counter() - t_phase
        log(f"{card}: fleet: router Prometheus text manifest-clean, {len(fams)} families; "
            f"int8_matmul launches by replica process {out['launches']}; boot s of every "
            f"replica process {out['boot_s']}; checks 1-2 in {out['seconds']:.3f} s")
    finally:
        fleet.terminate()
        try:
            fleet.wait(timeout=30)
        except subprocess.TimeoutExpired:
            fleet.kill()
            fleet.wait()
        for proc in restarted:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)
    return out


def phase_fleet_chaos(card: str, workdir: str, platform: str = "cuda",
                      disagg_extra: dict | None = None, engine_fn=None,
                      bert_extra: dict | None = None) -> dict:
    """Phase 21 checks 3-5, at once (their processes share the card): the
    fleet kill -9 test (BERT-base int8 ``:submit`` jobs behind a 600 ms
    latency rule), the variant kill -9 test (ResNet-18 rungs at 64 px) and
    the disaggregated kill -9 test (three GPT-2 small int8 paged replicas,
    r0 tagged prefill).  A disaggregated stream and the one resumed after
    the kill are held byte for byte against the same prompt undisturbed on
    one replica; where the card gives a differing token the margin rule
    decides (``engine_fn`` builds the model to hold them against).
    ``bert_extra`` narrows the fleet test's BERT (a CPU rehearsal)."""
    from pytorch_zappa_serverless_tpu_torch.tools import crashtest

    with ThreadPoolExecutor(3) as pool:
        flt = pool.submit(crashtest.run_fleet_crashtest, f"{workdir}/fleetcrash",
                          n_jobs=FLEET_JOBS, model="bert_int8", platform=platform,
                          latency_ms=FLEET_SLOW_MS, model_extra=bert_extra)
        var = pool.submit(crashtest.run_variant_crashtest, f"{workdir}/variants",
                          n_jobs=5, platform=platform)
        dis = pool.submit(crashtest.run_disagg_crashtest, f"{workdir}/disagg",
                          platform=platform, model_extra=disagg_extra)
        f, v, d = flt.result(), var.result(), dis.result()
    check(f["lost"] == 0 and f["completed"] == FLEET_JOBS
          and f["deduped_resubmits"] == FLEET_JOBS and f["backlog_at_kill"] >= 1, f"fleet: {f}")
    check(f["failover_predicts_ok"] >= 1 and max(f["failover_attempts"]) <= 2
          and f["quarantined_state"] == "quarantined" and f["readmitted_state"] == "healthy"
          and sum(f["failovers"].values()) >= 1 and f["quarantines"].get(f["victim"], 0) >= 1,
          f"fleet: {f}")
    check(f["dead_owner_poll"] in (200, 503), f"fleet: {f}")
    log(f"{card}: fleet kill -9: {f['victim']} killed with {f['backlog_at_kill']} of "
        f"{FLEET_JOBS} BERT int8 jobs queued (acked by replica {f['acked_by_replica']}): "
        f"4 predicts answered in {f['failover_attempts']} attempts, all within "
        f"{f['first_failover_s']} s of the kill; quarantined {f['kill_to_quarantine_s']} s "
        f"after the kill; a dead owner's job poll {f['dead_owner_poll']}; restarted on its "
        f"journal in {f['restart_boot_s']} s, readmitted {f['restart_to_readmit_s']} s after "
        f"the restart began; {f['completed']} jobs done, {f['deduped_resubmits']} resubmits "
        f"deduped; failovers {f['failovers']}; boots {f['replica_boot_s']} s")
    check(v["lost"] == 0 and v["completed"] == 5 and v["deduped_resubmits"] == 5,
          f"variants: {v}")
    check(v["degraded_predicts_ok"] >= 1 and set(v["served_variants"]) == {"rn_lite"}
          and v["quarantined_state"] == "quarantined" and v["readmitted_state"] == "healthy",
          f"variants: {v}")
    log(f"{card}: fleet variants: kill -9 of the replica with rn_full warm ({v['backlog_at_kill']} "
        f"jobs queued): family predicts served by {v['served_variants']}, "
        f"{v['degraded_predicts_ok']} degraded, first after {v['first_degraded_serve_s']} s; "
        f"quarantined after {v['kill_to_quarantine_s']} s, readmitted "
        f"{v['restart_to_readmit_s']} s after the restart; boots {v['replica_boot_s']} s, "
        f"restart {v['restart_boot_s']} s; 5 jobs done, 5 deduped")
    check(d["decode_replica"] != "r0" and d["resumed_on"] not in ("r0", d["decode_replica"]),
          f"disagg: {d}")
    check(d["migrations"].get("prefill", 0) >= 2 and d["migrations"].get("failover", 0) >= 1
          and d["failovers"].get("kv_failover", 0) >= 1, f"disagg: {d}")
    check(d["tokens"] == d["reference"], "disagg: the resumed stream differs from the reference")
    equal = d["reference"] == d["direct"]
    if not equal:
        log(f"{card}: fleet disagg: the moved streams differ from the same prompt on one "
            f"replica; held under the margin rule: {d['reference']} vs {d['direct']}")
        engine = engine_fn()
        try:
            from pytorch_zappa_serverless_tpu_torch.tools.crashtest import (DISAGG_MODEL,
                                                                            DISAGG_PROMPT)

            hold_streams(engine, "gpt2", [
                {"tag": tag, "ids": DISAGG_PROMPT, "tokens": toks, "ended": False, "knobs": {}}
                for tag, toks in (("moved", d["reference"]), ("direct", d["direct"]))],
                DISAGG_MODEL["extra"]["gen_slots"],
                (DISAGG_MODEL["prefill_chunk_tokens"], DISAGG_MODEL["kv_block_size"]))
        finally:
            engine.shutdown()
    log(f"{card}: fleet disagg: prefill on r0, decode on {d['decode_replica']}, killed after 4 "
        f"tokens, resumed on {d['resumed_on']}; tokens equal to the undisturbed stream through "
        f"the router, and to the same prompt on one replica: {equal}; prefill-to-decode cutover "
        f"{d['cutover_ms']} ms (first token to second; the median gap {d['token_gap_ms_median']} "
        f"ms), kill to the next token {d['kill_to_resume_ms']} ms; migrations "
        f"{d['migrations']}, failovers {d['failovers']}; the prefill replica's streams "
        f"{d['prefill_streams']}; boots {d['replica_boot_s']} s")
    return {"fleet": f, "variants": v, "disagg": d}


def _launch_sum(launches: dict) -> int:
    return sum(int(k.get("int8_matmul", 0)) if isinstance(k, dict) else int(k)
               for k in launches.values())


def run_fleet(card: str) -> dict:
    """Phase 21: the fleet router on the card.  The kernels are built (phase
    2) before any replica starts, so no replica's boot runs nvcc."""
    import tempfile

    from pytorch_zappa_serverless_tpu_torch.tools.crashtest import DISAGG_MODEL

    fresh_memory()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tpuserve-fleet-") as tmp:
        path = phase_fleet_path(card, tmp)

        def engine_fn():
            from pytorch_zappa_serverless_tpu_torch.config import ModelConfig, ServeConfig
            from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine

            m = {**DISAGG_MODEL, "batch_buckets": tuple(DISAGG_MODEL["batch_buckets"]),
                 "seq_buckets": tuple(DISAGG_MODEL["seq_buckets"])}
            return build_engine(ServeConfig(models=[ModelConfig(**m)]), "cuda")

        chaos = phase_fleet_chaos(card, tmp, engine_fn=engine_fn)
    launches = {**{k: v for k, v in path["launches"].items()},
                **{f"fleetcrash_{k}": v for k, v in chaos["fleet"]["launches"].items()},
                **{f"variants_{k}": v for k, v in chaos["variants"]["launches"].items()},
                **{f"disagg_{k}": v for k, v in chaos["disagg"]["launches"].items()}}
    total = _launch_sum(launches)
    secs = time.perf_counter() - t0
    log(f"{card}: the fleet (phase 21) in {secs:.3f} s; int8_matmul launches of every "
        f"replica process {launches}: {total} in all")
    return {"launches": total, "by_process": launches, "seconds": secs, "path": path,
            "chaos": chaos}


# -- phase 22: the deploy path -------------------------------------------------

# What phases 4 and 6 served, for phase 22 to hold the staged engine to: the
# BERT bodies with their predictions (buckets (1,128) and (8,128)), and the
# first SD-1.5 job's body with its PNG.
DEPLOY_REF: dict = {}


def load_sd_diffusers():
    """``tests/sd_diffusers.py``: the inverse of the SD-1.5 converters (a
    param tree → a diffusers-layout directory), shared with tier-1."""
    spec = importlib.util.spec_from_file_location("sd_diffusers", "tests/sd_diffusers.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same_tree_bytes(got: dict, want: dict) -> tuple[bool, str]:
    """Every leaf of the two trees of the same dtype, shape and bytes;
    returns (equal, the first leaf that is not)."""
    from pytorch_zappa_serverless_tpu_torch.engine import weights as W

    got, want = W.flatten_tree(got), W.flatten_tree(want)
    if sorted(got) != sorted(want):
        return False, f"keys {sorted(set(got) ^ set(want))[:5]}"
    for k, w in want.items():
        g = np.asarray(got[k])
        w = np.asarray(w)
        if g.dtype != w.dtype or g.shape != w.shape or not np.array_equal(
                g.reshape(-1).view(np.uint8), w.reshape(-1).view(np.uint8)):
            return False, k
    return True, ""


def deploy_models(checkpoint: str | None = None, bert_arch: dict | None = None,
                  sd_variant: str | None = None, **sd_extra) -> list[dict]:
    """BERT-base int8 (1, 8) x 128 with its labels as a list, and SD-1.5 at
    phase 6's settings (``checkpoint``: a diffusers directory), as a JSON
    config's models: phases 4 and 6 serve the same two."""
    bert = serve_config(arch=bert_arch).models[0]
    sd = sd_config(sd_variant, **sd_extra).models[0]
    bert_extra = {**bert.extra, "labels": ["label_0", "label_1"]}
    return [{"name": "bert_base", "dtype": bert.dtype, "seq_buckets": list(bert.seq_buckets),
             "batch_buckets": list(bert.batch_buckets), "extra": bert_extra},
            {"name": "sd15", "dtype": sd.dtype, "batch_buckets": list(sd.batch_buckets),
             "checkpoint": checkpoint, "extra": sd.extra}]


def cli_run(args: list[str], what: str, timeout: float = 600.0) -> subprocess.CompletedProcess:
    proc = subprocess.run([sys.executable, "-m", "pytorch_zappa_serverless_tpu_torch.cli", *args],
                          capture_output=True, text=True, timeout=timeout)
    check(proc.returncode == 0, f"{what}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    return proc


def serve_deploy_refs(engine, cfg, ref: dict) -> dict:
    """Phase 4's BERT bodies and phase 6's first job on ``engine``; returns
    the predictions, the job and the counts just after."""
    from pytorch_zappa_serverless_tpu_torch.serving.server import BackgroundServer

    with BackgroundServer(cfg, engine) as srv:
        preds = []
        for path, body, _ in ref["bert"]:
            status, out = http(srv.port, path, body)
            check(status == 200, f"{path}: status {status}: {out}")
            preds.append(out["predictions"])
        status, out = http(srv.port, "/v1/models/sd15:submit", ref["sd_body"])
        check(status == 202, f":submit: status {status}: {out}")
        job_id, deadline = out["job"]["id"], time.monotonic() + 600
        while True:
            status, out = http(srv.port, f"/v1/jobs/{job_id}")
            check(status == 200, f"/v1/jobs/{job_id}: status {status}: {out}")
            if out["job"]["status"] in ("done", "error"):
                break
            check(time.monotonic() < deadline, f"job {job_id} still {out['job']['status']}")
            time.sleep(0.05)
        counts = read_counts()  # just after the path
    return {"preds": preds, "job": out["job"], "counts": counts}


def phase_stage(card: str, workdir: str, platform: str = "cuda", bert_arch: dict | None = None,
                sd_variant: str | None = None, **sd_extra) -> dict:
    """Phase 22a, right after the kernels: ``cli deploy`` and ``cli stage`` in
    subprocesses, a diffusers-layout SD-1.5 directory written from the
    seeded tree, and the staged trees against the seeded ones.  Returns the
    staged ``config.json`` path, SD-1.5's staged checkpoint (phases 6 and 16
    boot from it) and the numbers.  The diffusers directory is removed once
    staged."""
    import shutil
    from pathlib import Path

    from pytorch_zappa_serverless_tpu_torch.config import load_config
    from pytorch_zappa_serverless_tpu_torch.engine import weights as W
    from pytorch_zappa_serverless_tpu_torch.models import bert as B
    from pytorch_zappa_serverless_tpu_torch.models import sd15 as S

    root = Path(workdir)
    t0 = time.perf_counter()
    # (1) cli deploy: the file set, and config.json loads back equal.
    cfg_path = root / "deploy_in.json"
    cfg_path.write_text(json.dumps({"profile": "h100", "models": deploy_models(
        bert_arch=bert_arch, sd_variant=sd_variant, **sd_extra)}))
    cli_run(["deploy", "--config", str(cfg_path), "--out", str(root / "deploy")], "cli deploy")
    files = sorted(p.name for p in (root / "deploy").iterdir())
    check(files == ["Dockerfile", "config.json", "deploy.json", "service.yaml", "undeploy.sh",
                    "warmpool.sh"], f"cli deploy wrote {files}")
    check(load_config(root / "deploy" / "config.json") == load_config(cfg_path),
          "cli deploy: config.json does not load back equal")
    # (2) a diffusers directory of the seeded tree, through the port's writer.
    t1 = time.perf_counter()
    seeded = S.init_sd15_params(0, S.TINY if sd_variant == "tiny" else S.FULL)
    load_sd_diffusers().write_diffusers_dir(seeded, root / "diffusers")
    ckpt_bytes = sum(f.stat().st_size for f in (root / "diffusers").rglob("*") if f.is_file())
    write_s = time.perf_counter() - t1
    # (3) cli stage.
    stage_in = root / "stage_in.json"
    stage_in.write_text(json.dumps({"profile": "h100", "models": deploy_models(
        str(root / "diffusers"), bert_arch, sd_variant, **sd_extra)}))
    out = root / "staged"
    t1 = time.perf_counter()
    cli_run(["stage", "--config", str(stage_in), "--out", str(out), "--mount-root",
             str(out / "assets"), "--platform", platform], "cli stage")
    stage_s = time.perf_counter() - t1
    shutil.rmtree(root / "diffusers")
    summary = json.loads((out / "stage.json").read_text())
    for name, info in summary["models"].items():
        log(f"{card}: staged {name}: {info['params_bytes']} bytes, {info['param_count']} "
            f"params, {info['seconds']} s (source {info['source']})")
    bert_mc, sd_mc = load_config(out / "config.json").models
    check(bert_mc.extra["labels"] == ["label_0", "label_1"]
          and bert_mc.extra["params_dtype"] == "int8", f"staged BERT extra {bert_mc.extra}")
    ok, where = same_tree_bytes(W.load_native(sd_mc.checkpoint), seeded)
    check(ok, f"the staged SD-1.5 tree differs from init_sd15_params(0) at {where}")
    del seeded
    bert_tree = W.load_native(bert_mc.checkpoint)
    check(not any(k.endswith("kernel_q") for k in W.flatten_tree(bert_tree)),
          "the staged BERT tree holds kernel_q")
    ok, where = same_tree_bytes(bert_tree, B.bert_tree(
        dataclasses.replace(bert_mc, checkpoint=None))[0])
    check(ok, f"the staged BERT tree differs from the port's seeded float tree at {where}")
    secs = time.perf_counter() - t0
    log(f"{card}: deploy path, staging (phase 22a) in {secs:.3f} s: the diffusers directory "
        f"(the seeded init and {ckpt_bytes} bytes) written in {write_s:.3f} s, cli stage "
        f"{stage_s:.3f} s ({summary['total_bytes']} bytes staged); the staged SD-1.5 tree "
        f"byte-equal to init_sd15_params(0), the staged BERT tree to the port's seeded float "
        f"tree, no kernel_q")
    return {"config": str(out / "config.json"), "sd_checkpoint": sd_mc.checkpoint,
            "seconds": secs, "stage_seconds": stage_s, "write_seconds": write_s,
            "summary": summary}


def phase_deploy_path(card: str, staged: dict, device: str = "cuda",
                      per_forward: int = 6 * BERT["layers"]) -> dict:
    """Phase 22b, last: an engine built from the staged ``config.json`` (phase
    22a) serving phase 4's BERT bodies and phase 6's first job, against what
    those phases served (``DEPLOY_REF``), and the kernels' launches."""
    from pytorch_zappa_serverless_tpu_torch.config import load_config
    from pytorch_zappa_serverless_tpu_torch.engine.loader import build_engine

    ref = DEPLOY_REF
    check({"bert", "sd_body", "sd_png"} <= set(ref), f"phases 4 and 6 left {sorted(ref)}")
    t0 = time.perf_counter()
    staged_cfg = load_config(staged["config"])
    reset_counts()
    engine = build_engine(staged_cfg, device)
    build_s = time.perf_counter() - t0
    try:
        served = serve_deploy_refs(engine, staged_cfg, ref)
        for (path, body, want), got in zip(ref["bert"], served["preds"]):
            check(got == want, f"staged BERT {path} {json.dumps(body)[:60]}: {got} != phase 4's "
                               f"{want}")
        job = served["job"]
        check(job["status"] == "done", f"staged SD-1.5 job: {job}")
        check(job["result"]["image_b64"] == ref["sd_png"],
              "the staged SD-1.5 PNG differs from phase 6's for the same body")
        counts = served["counts"]
        bert_fwd = (sum(e["model"] == "bert_base" for e in engine.clock.entries)
                    + engine.runner.stats["bert_base"].batches)
        calls = counts["unet_calls"]
        if per_forward:
            exact_counts(counts, {"int8_matmul": per_forward * bert_fwd,
                                  "flash_attention": 10 * calls, "unet_calls": calls},
                         "the staged engine")
            check(calls > 0 and bert_fwd > 0, f"the staged engine ran {counts}")
    finally:
        engine.shutdown()
    secs = time.perf_counter() - t0
    log(f"{card}: deploy path, the staged engine (phase 22b) in {secs:.3f} s (built in "
        f"{build_s:.3f} s); {bert_fwd} BERT forwards x {per_forward} int8_matmul, {calls} UNet "
        f"calls x 10 flash_attention: {counts}; BERT answers equal to phase 4's "
        f"({len(served['preds'])} bodies), the PNG equal to phase 6's; phase 22 "
        f"{staged['seconds'] + secs:.3f} s with 22a")
    return {"seconds": staged["seconds"] + secs, "int8_launches": counts["int8_matmul"],
            "flash_launches": counts["flash_attention"], "counts": counts}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Drive the port on one NVIDIA GPU.")
    ap.add_argument("--profile", action="store_true",
                    help="also profile served BERT forwards at both buckets, one SD-1.5 "
                         "denoise chunk, one served GPT-2 generate call, the three "
                         "GPT-2 decode lanes, served ResNet-50 (32,), EfficientNet-B0 (8,) "
                         "and ViT-B/16 (8,) forwards, one Whisper int8 generate call and "
                         "one GPT-2 int8 :generate segment (torch.profiler), one replayed "
                         "bucket-1 generate call of GPT-2 auto, int8 and bf16, and stamp the "
                         "fused kernels' phases")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    seconds: dict[str, float] = {}

    def timed(tag: str, fn, *a):
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            seconds[tag] = round(time.perf_counter() - t0, 1)

    card = timed("1 device", phase_device)
    timed("2 build", phase_build)
    kern = timed("3 kernels", phase_kernels)
    flash = timed("3 flash", phase_flash)
    # Phase 22a stages first: phases 6 and 16 boot SD-1.5 from its staged
    # tree (the seeded tree's bytes, checked there) instead of drawing the
    # seeded init again; phase 22b runs last.
    stage_dir = tempfile.TemporaryDirectory(prefix="tpuserve-deploy-")
    staged = timed("22a stage", phase_stage, card, stage_dir.name)
    int8_launches = timed("4-5 bert", run_bert, args.profile)
    flash_launches = timed("6-7 sd", run_sd, args.profile, staged["sd_checkpoint"])
    gpt2_launches = timed("8 gpt2", run_gpt2, args.profile)
    fused = timed("9 fused", run_fused, args.profile)
    vision = timed("10 vision", run_vision, args.profile)
    whisper = timed("11 whisper", run_whisper, args.profile)
    vit_embed = timed("12 vit_embed", run_vit_embed, args.profile)
    generate = timed("13 generate", run_generate, args.profile)
    failure = timed("14 failure", run_failure, card)
    residency = timed("15 residency", run_residency, card)
    plane = timed("16 plane", run_plane, card, staged["sd_checkpoint"])
    mobility = timed("17 mobility", run_mobility, card)
    adapters = timed("18 adapters", run_adapters, card, args.profile)
    tenancy = timed("19 tenancy", run_tenancy, card)
    ingest = timed("20 ingest", run_ingest, card)
    fleet = timed("21 fleet", run_fleet, card)
    fresh_memory()
    deploy = timed("22b deploy", phase_deploy_path, card, staged)
    stage_dir.cleanup()
    for m in MAIN_M:
        fwd = per_forward(kern["timings"], m)
        log(f"one forward's int8_matmul at M={m} (72 launches, the per-shape times summed): "
            f"kernel {fwd['ms']:.4f} ms, plain {fwd['plain_ms']:.4f} ms, cuBLAS "
            f"{fwd['library_ms']:.4f} ms ({fwd['ms'] / fwd['library_ms']:.3f} x), bound "
            f"{fwd['bound_ms']:.5f} ms ({fwd['bound_by']})")
    fwd = per_forward(kern["timings"], 1024)
    verify = per_verify(kern["timings"])
    log(f"one speculative verify forward's int8_matmul at M={SPEC_M} (49 launches, the "
        f"per-shape times summed): kernel {verify['ms']:.4f} ms, plain {verify['plain_ms']:.4f} "
        f"ms, cuBLAS {verify['library_ms']:.4f} ms ({verify['ms'] / verify['library_ms']:.3f} x), "
        f"bound {verify['bound_ms']:.5f} ms ({verify['bound_by']})")
    bert, step = kern["work"]["bert_fwd"], kern["work"]["gpt2_step"]
    wstep = kern["work"]["whisper_step"]
    unet = per_unet_call(flash["timings"])
    log(f"one UNet call's flash_attention at 512x512 (10 launches): kernel {unet['ms']:.4f} "
        f"ms, plain {unet['plain_ms']:.4f} ms, SDPA {unet['library_ms']:.4f} ms "
        f"({unet['ms'] / unet['library_ms']:.3f} x), bound {unet['bound_ms']:.5f} ms "
        f"({unet['bound_detail']}; {unet['bound_ms'] / unet['ms']:.3f} of the kernel's time)")
    kernels = [{
        "name": "int8_matmul", "route": "cuda",
        "source": "pytorch_zappa_serverless_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "pytorch_zappa_serverless_tpu/ops/int8_matmul.py:107",
        "launches": (int8_launches + plane["int8_launches"] + mobility["int8_launches"]
                     + adapters["auto_launches"] + tenancy["int8_launches"]
                     + ingest["launches"] + fleet["launches"] + deploy["int8_launches"]),
        "max_abs_err": kern["max_abs_err"],
        "ms": bert["ms"], "plain_ms": fwd["plain_ms"], "bound_ms": bert["bound_ms"],
        "bound_by": bert["bound_by"], "library_ms": bert["library_ms"],
        "timed_work": "one BERT-base forward at bucket (8,128): 72 launches at M=1024 over "
                      "12 layers' distinct weights, bf16 (plain: the per-shape times summed)",
        "per_shape_sum": {k: fwd[k] for k in ("ms", "library_ms", "bound_ms")},
        "gpt2_step": {**{k: step[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                              "bound_by")},
                      "lm_head_ms": kern["timings"][(8, *GPT2_HEAD)]["ms"],
                      "timed_work": "one GPT-2 small position step at M=8: 48 layer "
                                    "projections + the f32 lm head [768, 50304] over 123.6 MB "
                                    "of distinct int8 weights"},
        "launches_gpt2_path": gpt2_launches,
        "whisper_step": {**{k: wstep[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                  "bound_by")},
                         "lm_head_ms": kern["timings"][(4, *WHISPER_HEAD)]["ms"],
                         "timed_work": "one Whisper-tiny decoder position at M=4: 32 layer "
                                       "projections + the f32 lm head [384, 51968] over 28.2 MB "
                                       "of distinct int8 weights"},
        "launches_whisper_path": whisper["launches"],
        "launches_generate_path": generate["launches"],
        "launches_failure_path": failure["launches"],
        "launches_residency_path": residency["launches"],
        "launches_plane_path": plane["int8_launches"],
        "launches_mobility_path": mobility["int8_launches"],
        "launches_auto_path": adapters["auto_launches"],
        "launches_tenancy_path": tenancy["int8_launches"],
        "launches_ingest_path": ingest["launches"],
        "launches_fleet_path": fleet["launches"],
        "launches_fleet_by_process": fleet["by_process"],
        "launches_deploy_path": deploy["int8_launches"],
        "spec_verify": {**verify, "timed_work": f"one speculative verify forward of GPT-2 small "
                                                f"at M={SPEC_M}: 48 layer projections + the f32 "
                                                f"lm head, the per-shape times summed"},
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "pytorch_zappa_serverless_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "pytorch_zappa_serverless_tpu/ops/flash_attention.py:57",
        "launches": flash_launches + plane["flash_launches"] + deploy["flash_launches"],
        "max_abs_err": flash["max_abs_err"],
        "launches_plane_path": plane["flash_launches"],
        "launches_deploy_path": deploy["flash_launches"],
        "ms": unet["ms"], "plain_ms": unet["plain_ms"], "bound_ms": unet["bound_ms"],
        "bound_by": unet["bound_by"], "library_ms": unet["library_ms"],
        "bound_detail": unet["bound_detail"],
        "timed_work": "one SD-1.5 UNet call at 512x512: 5 launches at [2,4096,8,40] "
                      "+ 5 at [2,1024,8,80], bf16",
    }]
    for name, kind, lane, line in (("fused_attn_step", "attn", "fused", 86),
                                   ("fused_attn_step_int8", "attn", "fused_int8", 97),
                                   ("fused_mlp_step", "mlp", "fused", 216),
                                   ("fused_mlp_step_int8", "mlp", "fused_int8", 222)):
        row = fused["kernels"][lane]["timing"][kind]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pytorch_zappa_serverless_tpu_torch/ops/csrc/fused_decode.cu",
            "replaces": f"pytorch_zappa_serverless_tpu/ops/fused_decode.py:{line}",
            "launches": fused["counts"][name],
            "max_abs_err": fused["kernels"][lane]["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "unfused_step_ms": fused["ms"]["seg1"],
            "step_ms": {"replayed": fused["ms"][lane], "eager": fused["eager_ms"][lane]},
            "timed_work": "one launch at GPT-2 small [S=8, D=768, T=96, F=3072], "
                          + ("int8 (W8A16)" if lane == "fused_int8" else "bf16")
                          + " weights, the mean over all 12 layers",
        })
    for (name, bucket), row in sorted(vision["timing"].items()):
        log(f"vision {name} ({bucket},): replayed {row['replay_ms']:.4f} ms, eager "
            f"{row['eager_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms ({row['gflop']:.2f} GFLOP)")
    log(f"vision served p50 (resnet50, single PNGs): {vision['p50_ms']:.3f} ms; the vision "
        f"path runs no kernel of the port (cuDNN convolutions, cuBLAS fc)")
    for (name, bucket), row in sorted(whisper["timing"].items()):
        log(f"whisper {name} ({bucket},): a generate call replayed {row['replay_ms']:.4f} ms, "
            f"eager {row['eager_ms']:.4f} ms; encoder {row['encoder_ms']:.4f} ms, "
            f"{row['decode_position_ms']:.4f} ms a decoder position")
    log(f"whisper served p50 (int8, single 3 s WAVs): {whisper['p50_ms']:.3f} ms; host "
        f"log-mel per 30 s window {whisper['host']}; int8_matmul a decoder position at M=4 "
        f"{wstep['ms']:.4f} ms (cuBLAS {wstep['library_ms']:.4f}, bound {wstep['bound_ms']:.5f})")
    for (name, bucket), row in sorted(vit_embed["timing"].items()):
        log(f"{name} {bucket}: replayed {row['replay_ms']:.4f} ms, eager {row['eager_ms']:.4f} ms")
    for name, bursts in generate["stats"].items():
        spread = {k: (statistics.median(b[k] for b in bursts), min(b[k] for b in bursts),
                      max(b[k] for b in bursts))
                  for k in ("ttft_p50", "ttft_p99", "itl_p50", "tok_per_s")}
        log(f"generate {name}: {bursts[0]['streams']} SSE streams from client threads in the "
            f"server's process, median [min, max] over {len(bursts)} bursts: "
            + ", ".join(f"{k} {m:.3f} [{lo:.3f}, {hi:.3f}]" for k, (m, lo, hi) in spread.items()))
    for name, row in generate["timing"].items():
        log(f"generate {name}: a greedy segment replayed {row['replay_ms']:.4f} ms, eager "
            f"{row['eager_ms']:.4f} ms; lane cold start (its pool and every graph) "
            f"{generate['lane_cold_s'].get(name, 0.0):.3f} s")
    log(f"{card}: chip_smoke took {time.perf_counter() - t_start:.1f} s in all; seconds by "
        f"phase {seconds}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
