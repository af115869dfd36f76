"""`python -m nanosandbox_tpu_torch.serve` — serve a checkpoint on the GPU.

Loads <out_dir>/serving.pt (checkpoint.save_for_serving; a JAX-trained
checkpoint converts through models/convert.py), casts the weights to
the compute dtype, and exposes the continuous-batching engine over HTTP:

    python -m nanosandbox_tpu_torch.serve --out_dir=out_torch --port=8000 &
    curl -s localhost:8000/generate -d '{"prompt_tokens": [1, 2, 3],
        "max_new_tokens": 32, "temperature": 0.8, "top_k": 40}'
    curl -s localhost:8000/stats
    curl -s localhost:8000/metrics                 # Prometheus text
    curl -s 'localhost:8000/trace?rid=0'           # Chrome trace JSON
    curl -s 'localhost:8000/debug/requests?rid=0'  # flight events
    curl -s localhost:8000/profile -d '{"steps": 16}'

With --spec=ngram (or model:<out_dir>) each step drafts --spec_k
tokens a request and verifies them in one batched forward; --faults arms
a fault-injection plan (serve/faults.py; steps counted from the end of
the warmup); an EngineSupervisor recovers from faults unless
--no_recovery. The anomaly watchdogs run unless --no_watchdogs, dumping
under --watchdog_dir; the warmup's end marks the program set steady, so
a CUDA graph captured or a kernel library built later trips
post_freeze_retrace; under --warmup=full the loop serves with the
capture budgets frozen (utils/tracecheck.py), so such a build raises
CompileBudgetExceeded in the engine loop first. The process vitals (RSS, fds, uptime, CUDA
allocator bytes) ride every /metrics scrape.

--device defaults to auto, which is the GPU and raises without one;
--device=cpu runs the plain PyTorch attention instead of the kernels.
Tokenizer flags are optional: without --data_dir, only prompt_tokens
requests are served.

Multi-replica serving: --role=prefill|decode makes a replica one tier of
disaggregated serving (a prefill replica answers a migrate-flagged
/generate with 202 and its block chain; a decode replica adopts chains
through /internal/adopt, runs no prefill and warms no prefill wave;
--role=decode needs --paged=on). --router runs the front tier instead of
a replica: an asyncio proxy over --replicas (comma-separated base URLs,
or dns+http://name:port) routing by prefix affinity (--router_page must
match the replicas' --kv_page_size; --no_affinity routes seeded-random),
polling each replica every --health_interval_s, and proxying the two
legs of a migration while a prefill and a decode replica are both ready.
It loads no checkpoint and needs no GPU:

    python -m nanosandbox_tpu_torch.serve --out_dir=out_torch --port=8001 \
        --role=prefill &
    python -m nanosandbox_tpu_torch.serve --out_dir=out_torch --port=8002 \
        --role=decode &
    python -m nanosandbox_tpu_torch.serve --router --port=8000 \
        --replicas=http://127.0.0.1:8001,http://127.0.0.1:8002 &
"""

from __future__ import annotations

import argparse
import contextlib
import sys

from nanosandbox_tpu_torch.utils import tracecheck


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m nanosandbox_tpu_torch.serve")
    ap.add_argument("--router", action="store_true",
                    help="run the fleet's front tier instead of a replica: "
                         "an asyncio proxy routing POST /generate across "
                         "--replicas by radix-prefix affinity, with health "
                         "and load fallback and failover re-routing. Loads "
                         "no checkpoint and needs no GPU")
    ap.add_argument("--replicas", default="",
                    help="router mode: comma-separated replica base URLs "
                         "(http://host:port), or a dns+http://name:port "
                         "spec resolved every health interval")
    ap.add_argument("--health_interval_s", type=float, default=2.0,
                    help="router mode: seconds between each replica's "
                         "health, load and prefix-summary polls; a "
                         "draining or dead replica leaves rotation within "
                         "one interval")
    ap.add_argument("--router_page", type=int, default=16,
                    help="router mode: the replicas' KV page size (their "
                         "--kv_page_size), or no prefix fingerprint will "
                         "ever match")
    ap.add_argument("--no_affinity", action="store_true",
                    help="router mode: route seeded-random over the ready "
                         "replicas (the affinity-blind baseline)")
    ap.add_argument("--role", default="both",
                    choices=("both", "prefill", "decode"),
                    help="disaggregated serving tier: 'prefill' answers a "
                         "migrate-flagged /generate with 202 and its block "
                         "chain; 'decode' adopts chains via /internal/adopt "
                         "with no prefill (and warms no prefill wave; needs "
                         "--paged=on); 'both' (default) serves colocated")
    ap.add_argument("--out_dir", default="out")
    ap.add_argument("--data_dir", default="",
                    help="prepared-dataset root holding <dataset>/meta.pkl "
                         "(text prompts); empty = prompt_tokens only")
    ap.add_argument("--dataset", default="shakespeare_char")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000,
                    help="0 picks a free port")
    ap.add_argument("--num_slots", type=int, default=8,
                    help="concurrent request capacity (decode batch rows)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: ONE engine over N "
                         "shards — Megatron weight placements, the KV "
                         "pool (and its scale planes) split along heads, "
                         "slot state replicated. Greedy outputs are "
                         "token-identical to tp=1; /stats and /metrics "
                         "carry it (serve_tp_degree). Requires n_head "
                         "%% tp == 0; every shard runs on --device (one "
                         "card); 1 = the single-shard engine, unchanged")
    ap.add_argument("--max_len", type=int, default=0,
                    help="per-request KV length; 0 = block_size")
    ap.add_argument("--device", default="auto",
                    help="auto (the GPU; raises without one) | cuda | cpu")
    ap.add_argument("--paged", default="on", choices=("on", "off"),
                    help="on: the block-paged KV pool with prefix reuse; "
                         "off: the dense pool, one max_len row per slot")
    ap.add_argument("--kv_page_size", type=int, default=16,
                    help="positions per KV block (paged only)")
    ap.add_argument("--kv_pool_blocks", type=int, default=0,
                    help="pool size in blocks; 0 = num_slots * max_len / "
                         "page (paged only)")
    ap.add_argument("--no_prefix_cache", action="store_true",
                    help="disable radix prefix reuse (paged only)")
    ap.add_argument("--kv_dtype", default=None,
                    choices=("fp32", "bf16", "int8", "int4"),
                    help="KV pool storage (default: the compute dtype); "
                         "int8 and int4 (two values per byte) keep one "
                         "f32 scale per position and quantize on write")
    ap.add_argument("--no_pipeline", action="store_true",
                    help="synchronous decode loop (dispatch, read back, "
                         "retire); default keeps one decode chunk in "
                         "flight ahead of the host")
    ap.add_argument("--prefill_chunk", type=int, default=0,
                    help="per-step prefill token budget (one of the "
                         "prefill buckets; 0 = off): admission waves are "
                         "paced and long prompts split into chunk-sized "
                         "prefills interleaved with decode steps, so a "
                         "prefill storm cannot stall the active requests' "
                         "tokens. Paged pools only for the splitting half")
    ap.add_argument("--no_preemption", action="store_true",
                    help="disable deadline-driven preemption (default on: "
                         "when the highest-priority queued request would "
                         "miss its deadline waiting on slots or KV blocks, "
                         "the lowest-priority active request is evicted; "
                         "its blocks go to the prefix cache and it "
                         "resumes, with the same tokens, as a prefix hit)")
    ap.add_argument("--brownout", default="on", choices=("on", "off"),
                    help="SLO-driven brownout ladder (default on): under "
                         "sustained deadline burn the engine steps through "
                         "shrink-scan -> suspend-spec -> shed-batch -> "
                         "interactive-only, with hysteresis. Costs nothing "
                         "without deadlines")
    ap.add_argument("--deadline_s", type=float, default=0.0,
                    help="default per-request SLO deadline in seconds "
                         "(submit -> finish) for requests that send none; "
                         "0 = best-effort. A queued request past its "
                         "deadline is shed (429 + Retry-After)")
    ap.add_argument("--scan_k", type=int, default=1,
                    help="decode steps one dispatch may run (one CUDA "
                         "graph replay per chunk, chunk lengths 1, 2, 4, "
                         "..., scan_k); finish detection lags the chunk. "
                         "Tokens are the same for every value")
    ap.add_argument("--decode_impl", default=None,
                    choices=("auto", "pallas", "pallas_interpret", "xla"),
                    help="the JAX engine's names: auto and pallas are the "
                         "decode kernels; pallas_interpret and xla are "
                         "accepted and select nothing")
    ap.add_argument("--spec", default="off",
                    help="speculative decoding: 'ngram' (prompt lookup) "
                         "or 'model:<out_dir>' (a smaller GPT of the same "
                         "vocabulary drafting greedily); up to spec_k+1 "
                         "tokens a target forward, greedy outputs "
                         "unchanged. Forces the synchronous loop and "
                         "scan_k 1")
    ap.add_argument("--spec_k", type=int, default=4,
                    help="draft tokens per verify step (--spec only)")
    ap.add_argument("--faults", default=None,
                    help="arm a deterministic fault-injection plan "
                         "(serve/faults.py): 'site@step[xN][:param]' "
                         "entries comma-separated, or a canned plan name "
                         "('chaos-smoke', 'chaos-full'); steps count from "
                         "the end of the warmup")
    ap.add_argument("--watchdog_dir", default=None,
                    help="directory for anomaly-watchdog dumps (flight "
                         "ledger + span ring + stats snapshot per trip); "
                         "default: a temporary directory made at the "
                         "first trip")
    ap.add_argument("--no_watchdogs", action="store_true",
                    help="disable the anomaly watchdogs (TTFT spike, "
                         "admission stall, pool thrash, post-warmup "
                         "build, stuck slot, stalled step)")
    ap.add_argument("--no_recovery", action="store_true",
                    help="no engine supervisor: a dispatch error kills the "
                         "serving loop, and a row poisoned 3 times in a "
                         "row ends 'failed' instead of recovering")
    ap.add_argument("--warmup", choices=("full", "buckets"), default="full",
                    help="before binding the port, 'full' runs one "
                         "admission wave for every (wave size, prefill "
                         "bucket) pair, 'buckets' one single-request wave "
                         "per bucket; both then dispatch every decode "
                         "chunk length once")
    return ap


def warm_up(engine, mode: str) -> int:
    """The JAX server's warmup before the port binds: one admission wave
    for every (admit rung x prefill bucket) pair ('full') or for rung 1
    only ('buckets'), each prompt mapping to its bucket, with the prefix
    cache flushed between waves so that no warmup prompt shortens the
    next one's suffix or serves a hit to live traffic; then every decode
    chunk length once over the parked slots, and the latency windows
    cleared. 'decode' (a decode-tier replica) runs no wave. Returns the
    waves run."""
    rungs = engine.admit_buckets if mode == "full" else [1]
    waves, lo = 0, 1
    for bucket in engine.sched.buckets if mode != "decode" else ():
        # A length in (previous bucket, bucket], leaving room for two new
        # tokens so the wave's rows also reach the decode step; a bucket
        # reachable only by one-token requests warms with one.
        length, new_tokens = min(bucket, engine.max_len - 2), 2
        lo, prev_lo = bucket + 1, lo
        if length < prev_lo:
            length, new_tokens = min(bucket, engine.max_len - 1), 1
            if length < prev_lo:
                continue
        for k in rungs:
            for _ in range(k):
                engine.submit([0] * length, new_tokens)
            engine.drain()
            engine.reset_prefix_cache()
            waves += 1
    engine.warm_scan_rungs()
    engine.reset_latency_stats()
    return waves


def build_router(args):
    """The started RouterFrontend of --router mode (no checkpoint, no
    torch device)."""
    from nanosandbox_tpu_torch.serve.http import RouterFrontend

    replicas = [u.strip() for u in args.replicas.split(",") if u.strip()]
    if not replicas:
        raise SystemExit("--router needs --replicas=<url,url,...> or "
                         "--replicas=dns+http://name:port")
    fe = RouterFrontend(replicas, host=args.host, port=args.port,
                        page=args.router_page,
                        health_interval_s=args.health_interval_s,
                        affinity=not args.no_affinity).start()
    print(f"[serve-router] routing {replicas} (affinity="
          f"{'off' if args.no_affinity else 'on'}, page={args.router_page}, "
          f"health every {args.health_interval_s}s); listening on "
          f"{args.host}:{fe.port} (POST /generate, GET /healthz "
          "/debug/router /metrics)", file=sys.stderr, flush=True)
    return fe


def build_server(argv: list[str] | None = None):
    """(server, loop, engine): the checkpoint loaded, the engine warmed
    (warm_up, --warmup), its loop thread started, and the HTTP
    server bound (not yet serving). The caller runs
    ``server.serve_forever()`` and, at the end, ``loop.stop()`` and
    ``server.server_close()``."""
    from nanosandbox_tpu_torch.checkpoint import load_for_serving
    from nanosandbox_tpu_torch.config import resolve_device
    from nanosandbox_tpu_torch.data.tokenizer import tokenizer_for_dataset
    from nanosandbox_tpu_torch.models.gpt import GPT, cast_for_serving
    from nanosandbox_tpu_torch.obs import register_process_vitals
    from nanosandbox_tpu_torch.serve.drafters import drafter_from_flag
    from nanosandbox_tpu_torch.serve.engine import Engine
    from nanosandbox_tpu_torch.serve.faults import FaultPlan
    from nanosandbox_tpu_torch.serve.http import EngineLoop, make_server
    from nanosandbox_tpu_torch.serve.recovery import EngineSupervisor

    args = build_parser().parse_args(argv if argv is not None
                                     else sys.argv[1:])
    if args.router:
        raise SystemExit("--router runs the front tier: use main()")
    if args.role == "decode" and args.paged != "on":
        raise SystemExit("--role=decode needs --paged=on: adoption is a "
                         "paged block-chain operation")
    # A fault plan parses before the checkpoint loads (a typo fails at
    # once) and stays disarmed through the warmup.
    fault_plan = None
    if args.faults:
        try:
            fault_plan = FaultPlan.parse(args.faults)
        except ValueError as e:
            raise SystemExit(f"--faults: {e}")
        fault_plan.enabled = False
    device = resolve_device(args.device)
    drafter = drafter_from_flag(args.spec, k=args.spec_k, device=device)
    cfg, state_dict = load_for_serving(args.out_dir)
    model = GPT(cfg, device=device)
    model.load_state_dict(state_dict)
    cast_for_serving(model)
    tok = (tokenizer_for_dataset(args.data_dir, args.dataset)
           if args.data_dir else None)
    engine = Engine(model, num_slots=args.num_slots,
                    max_len=args.max_len or None, kv_dtype=args.kv_dtype,
                    paged=args.paged == "on",
                    kv_page_size=args.kv_page_size,
                    kv_pool_blocks=args.kv_pool_blocks or None,
                    prefix_cache=not args.no_prefix_cache,
                    pipeline=not args.no_pipeline, scan_k=args.scan_k,
                    decode_impl=args.decode_impl,
                    default_deadline_s=args.deadline_s or None,
                    prefill_chunk=args.prefill_chunk or None,
                    preemption=not args.no_preemption,
                    brownout=args.brownout == "on", spec=drafter,
                    faults=fault_plan, watchdogs=not args.no_watchdogs,
                    watchdog_dir=args.watchdog_dir, role=args.role,
                    tp=args.tp, device=device)
    # Every prefill shape and decode chunk once before the port binds, so
    # no client pays for the libraries' first-call setup. A decode replica
    # never prefills: it warms its decode chunks only.
    waves = warm_up(engine, "decode" if args.role == "decode"
                    else args.warmup)
    # The program set is complete: a graph captured or a kernel library
    # built from now on eats a live request's time, and pages.
    engine.watchdog.mark_steady()
    register_process_vitals()
    if fault_plan is not None:
        fault_plan.rearm(engine.steps)
        fault_plan.enabled = True
        print(f"[serve] fault plan armed: {fault_plan.describe()}",
              file=sys.stderr, flush=True)
    supervisor = None if args.no_recovery else EngineSupervisor(engine)
    loop = EngineLoop(engine, supervisor=supervisor)
    loop.start()
    server = make_server(
        args.host, args.port, loop,
        tok.encode if tok is not None else None,
        (lambda ids: tok.decode([int(t) for t in ids]))
        if tok is not None else None)
    pool = (f"paged pool {engine.kv_pool_blocks} blocks x "
            f"{engine.kv_page_size}" if engine.paged else "dense pool")
    print(f"[serve] {cfg.n_layer}L/{cfg.n_embd}d on {engine.device}: "
          f"{engine.num_slots} slots x {engine.max_len} ctx, {pool} "
          f"(kv_dtype={engine.kv_dtype}, pipeline="
          f"{'on' if engine.pipeline else 'off'}, scan_k={engine.scan_k}, "
          f"{engine.max_programs()['decode']} decode graphs, "
          f"decode_impl={engine.decode_impl}, "
          f"prefill_chunk={engine.prefill_chunk or 'off'}, preemption="
          f"{'on' if engine.preemption else 'off'}, brownout="
          f"{'on' if engine.brownout is not None else 'off'}, spec="
          f"{args.spec if drafter is not None else 'off'}"
          f"{f' k={drafter.k}' if drafter is not None else ''}, recovery="
          f"{'off' if supervisor is None else 'on'}, watchdogs="
          f"{'off' if args.no_watchdogs else 'on'}, role={args.role}); "
          f"warmup {args.warmup}: "
          f"{waves} prefill waves; listening on {args.host}:"
          f"{server.server_address[1]} (POST /generate /drain /profile, "
          "GET /healthz[?ready=1] /stats /metrics /trace /debug/requests "
          "/debug/slots /debug/kvpool /debug/scheduler /debug/prefix_summary"
          + (", POST /internal/adopt /internal/export_done"
             if args.role != "both" else "") + ")", file=sys.stderr,
          flush=True)
    return server, loop, engine


def frozen_programs(engine, warmup: str):
    """The post-warmup freeze: under ``--warmup=full`` the engine's
    capture budgets and the process's kernel-library budget
    (utils/tracecheck.py), so a capture or a library load on a live
    request raises CompileBudgetExceeded in the engine loop instead of
    costing that request its latency (JAX freezes its jit traces the
    same way). ``--warmup=buckets`` freezes nothing."""
    stack = contextlib.ExitStack()
    if warmup == "full":
        stack.enter_context(engine.tracecheck.frozen())
        stack.enter_context(tracecheck.global_registry().frozen())
    return stack


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv if argv is not None
                                     else sys.argv[1:])
    if args.router:
        import time

        fe = build_router(args)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            fe.stop()
        return
    server, loop, engine = build_server(argv)
    try:
        with frozen_programs(engine, args.warmup):
            server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        loop.stop()
        server.server_close()


if __name__ == "__main__":
    main()
