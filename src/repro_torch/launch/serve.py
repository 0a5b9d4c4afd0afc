"""Online serving tier: schedule decisions under a per-request budget.

Port of repro/launch/serve.py: the ``serve_gnn`` and ``demo-lm``
subcommands. `serve_gnn`, the default subcommand, drives concurrent
client streams of sampled subgraphs into one `GNNServer`. Every request
is answered from one of four tiers:

  warm         a pinned bucket decision (local probe, warm cache open, or
               a drift-flagged bucket still serving its last pin),
               answered inline at the cost of feature extraction
  transfer     a peer device class's probed ranking re-ranked under the
               local roofline (core/transfer.py), answered inline in
               estimate space
  provisional  a cold bucket: the guardrail-safe baseline is served at
               once while the bucket's probe runs on the background
               probe worker, which upgrades the bucket in place
               (`BatchScheduler.pump()`), never on the request path
  cold         a request that paid a probe inline; the server never does
               this, and `autosage_probe_stalls_total` counts any

Every request returns within `AUTOSAGE_SERVE_BUDGET_MS` of decision
latency (not kernel time). Per-bucket latency lands in
`autosage_serve_request_ms{bucket,tier}` (core/obs.py), and one JSONL
record per request, upgrade and session in serve_events.jsonl
(core/telemetry.py).

On a card the worker does not hide a kernel's fault: the first probe
exception that `resilience.must_raise` or that a kernel site surfaced
stops the worker, and the next `submit`, `drain` or `close` re-raises
it. Elsewhere a probe exception is only counted
(`autosage_serve_probe_errors_total`), as in the JAX package.

    # on the card: 4 clients, 2 passes over a 4-regime stream
    PYTHONPATH=src python -m repro_torch.launch.serve serve_gnn \\
        --clients 4 --requests 64
    # on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

`demo-lm` prefills a batch of random prompts through an LLM of
`repro_torch.configs` and decodes greedily, optionally through the
sliding-window + sink CSR attention (``--long-ctx``):

    PYTHONPATH=src python -m repro_torch.launch.serve demo-lm \\
        --arch qwen3_14b --reduced --batch 4 --prompt-len 64 --gen 32

Under ``python -m torch.distributed.run --nproc-per-node N -m
repro_torch.launch.serve demo-lm ...`` each rank builds `make_host_mesh`
and draws the same weights and prompts; the batch rows are split by
`batch_axes_for` (MoE layers expert parallel). With ``--long-ctx`` and
``REPRO_LONG_ATTN=sharded`` every rank prefills every row, keeps its
slice of each attention cache's sequence and decodes through
`csr_window_attention_sharded`. Rank 0 prints every row's tokens.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core import obs, resilience, telemetry
from repro_torch.core.batch import BatchScheduler
from repro_torch.core.scheduler import AutoSage, Decision

DEFAULT_SERVE_BUDGET_MS = 50.0


def _budget_ms() -> float:
    """Per-request decision budget, read per call (tests rotate env)."""
    try:
        return float(os.environ.get("AUTOSAGE_SERVE_BUDGET_MS", DEFAULT_SERVE_BUDGET_MS))
    except ValueError:
        return DEFAULT_SERVE_BUDGET_MS


@dataclasses.dataclass
class ServeResult:
    """One served request: the decision plus its admission accounting."""

    decision: Decision
    tier: str  # warm | transfer | provisional | cold
    source: str  # the BatchScheduler tier label behind the mapping
    bucket: str  # bucket sig the request was admitted into
    latency_ms: float
    stalled: bool  # a probe ran on this request's path (must not happen)


class GNNServer:
    """One serving process: admission by bucket over a `BatchScheduler`,
    probing on a background worker thread.

    The scheduler runs with ``auto_pump=False``, so `submit()` never
    probes. A cold bucket opens inline (estimate space only), serves its
    provisional baseline and waits for the worker, which calls `pump()`
    off the request path and upgrades the bucket's decision in place;
    `BatchScheduler.on_upgrade` feeds the serve metrics and
    serve_events.jsonl. Use as a context manager or call `close()`, so
    the bucket decisions pin into the cache for replay. Without a
    scheduler the server builds one on ``device``: the card unless the
    caller asks for the CPU."""

    _TIER_BY_SOURCE = {
        "bucket-cache": "warm",
        "probe": "warm",
        # a drift-flagged bucket keeps serving its last pinned decision
        # while its re-probe waits in the background
        "drift-pending": "warm",
        "transfer": "transfer",
        "transfer-pending": "transfer",
        "provisional": "provisional",
    }
    # sources whose bucket has a probe waiting: wake the worker
    _PENDING_SOURCES = ("provisional", "transfer-pending", "drift-pending")

    def __init__(
        self,
        scheduler: Optional[BatchScheduler] = None,
        budget_ms: Optional[float] = None,
        background_probes: bool = True,
        device=None,
    ):
        self.bs = scheduler if scheduler is not None else BatchScheduler(AutoSage(device=device))
        self.bs.auto_pump = False  # probes never run on the request path
        self.bs.on_upgrade = self._on_upgrade
        self.budget_ms = float(budget_ms) if budget_ms is not None else _budget_ms()
        self._stats_lock = threading.Lock()
        self.requests = 0
        self.tier_counts: Dict[str, int] = {}
        self.stalls = 0
        self.over_budget = 0
        self.upgrades = 0
        self.upgrade_events: List[Dict[str, Any]] = []
        self.latencies_ms: List[float] = []
        self._closed = False
        self._fault: Optional[BaseException] = None  # a card fault the worker kept
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._worker: Optional[threading.Thread] = None
        if background_probes and not self.bs.cache.replay_only:
            self._worker = threading.Thread(
                target=self._probe_loop, name="autosage-probe-worker", daemon=True,
            )
            self._worker.start()

    def _raise_fault(self) -> None:
        if self._fault is not None:
            raise self._fault

    # ------------------------------------------------------ request path
    def submit(self, csr, f: int, op: str = "spmm") -> ServeResult:
        """Serve one request within the decision budget: warm and
        transfer inline; a cold bucket gets the provisional baseline while
        its probe runs in the background."""
        self._raise_fault()
        t0 = time.perf_counter()
        d = self.bs.decide(csr, f, op)
        latency_ms = (time.perf_counter() - t0) * 1e3
        source = self.bs.last_source or "provisional"
        stalled = self.bs.last_inline_probes > 0
        tier = "cold" if stalled else self._TIER_BY_SOURCE.get(source, "provisional")
        bucket = self.bs.last_bucket
        sig = bucket.sig() if bucket is not None else "?"
        with self._stats_lock:
            self.requests += 1
            self.tier_counts[tier] = self.tier_counts.get(tier, 0) + 1
            self.latencies_ms.append(latency_ms)
            if stalled:
                self.stalls += 1
            if latency_ms > self.budget_ms:
                self.over_budget += 1
        obs.record_serve_request(sig, tier, latency_ms, op=op)
        if stalled:
            obs.record_probe_stall(tier)
        telemetry.emit_serve_event({
            "event": "request",
            "bucket": sig,
            "op": op,
            "f": f,
            "tier": tier,
            "source": source,
            "choice": d.choice,
            "latency_ms": round(latency_ms, 4),
            "budget_ms": self.budget_ms,
            "stalled": stalled,
        }, self.bs.sage.device)
        if source in self._PENDING_SOURCES:
            self._wake.set()
        return ServeResult(decision=d, tier=tier, source=source, bucket=sig,
                           latency_ms=latency_ms, stalled=stalled)

    def run(self, csr, decision: Decision):
        """The runner of a served decision (AutoSage-compatible). Each call
        records a ``run`` span: its wall time is host time, so around a
        CUDA launch it measures the launch; its device time (on a card)
        goes to ``autosage_device_ms``."""
        runner = self.bs.build_runner(csr, decision)

        def served(*args):
            with obs.span("run", args[-1].device, op=decision.op, choice=decision.choice):
                return runner(*args)

        return served

    # -------------------------------------------------- background probes
    def _probe_loop(self) -> None:
        device = self.bs.sage.device
        # the worker launches on its device's default stream, beside the
        # request threads' runners
        on_card = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
        with on_card:
            while not self._stop.is_set():
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                if self._stop.is_set():
                    break
                try:
                    # one bucket per pump, so a stop lands between probes
                    while not self._stop.is_set() and self.bs.pump(1):
                        pass
                except Exception as exc:  # noqa: BLE001 - worker boundary
                    obs.REGISTRY.inc("autosage_serve_probe_errors_total")
                    if resilience.must_raise(exc, device) or not resilience.rescuable(exc):
                        # a kernel's fault on the card: keep it for the
                        # request path and stop probing
                        self._fault = exc
                        return
                    # otherwise the bucket keeps serving provisionally and
                    # resilience / quarantine handle the candidate

    def _on_upgrade(self, event: Dict[str, Any]) -> None:
        """A background (or drift re-) probe just upgraded a bucket's
        decision in place."""
        with self._stats_lock:
            self.upgrades += 1
            self.upgrade_events.append(event)
        obs.REGISTRY.inc("autosage_serve_upgrades_total", op=event.get("op", "?"))
        telemetry.emit_serve_event({
            "event": "upgrade",
            "kind": event.get("event"),
            "bucket": event.get("bucket"),
            "op": event.get("op"),
            "choice": event.get("choice"),
            "probe_overhead_ms": event.get("probe_overhead_ms"),
        }, self.bs.sage.device)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Block until no bucket is pending a probe (or timeout). Serving
        goes on meanwhile; this only waits on the background worker."""
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            self._raise_fault()
            if not self.bs.pending():
                return True
            self._wake.set()
            time.sleep(0.005)
        self._raise_fault()
        return not self.bs.pending()

    # ------------------------------------------------------------ session
    def serve_stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            lat = sorted(self.latencies_ms)
            stats: Dict[str, Any] = {
                "requests": self.requests,
                "by_tier": dict(self.tier_counts),
                "stalls": self.stalls,
                "over_budget": self.over_budget,
                "upgrades": self.upgrades,
                "budget_ms": self.budget_ms,
            }

        def q(p: float) -> Optional[float]:
            return lat[min(int(p * len(lat)), len(lat) - 1)] if lat else None

        stats.update(
            p50_ms=q(0.50), p95_ms=q(0.95), p99_ms=q(0.99),
            max_ms=lat[-1] if lat else None,
            pending_buckets=len(self.bs.pending()),
            buckets=self.bs.stats()["buckets"],
        )
        return stats

    def close(self, finalize: bool = True, timeout_s: float = 10.0) -> Dict[str, Any]:
        """Stop the probe worker, pin every bucket decision into the cache
        (for replay) and emit the session summary. A hung probe cannot
        hang close: the worker is a daemon thread, and finalize is skipped
        if it failed to join. A card fault the worker kept re-raises here,
        before anything is pinned."""
        if self._closed:
            return self.serve_stats()
        self._closed = True
        self._stop.set()
        self._wake.set()
        hung = False
        if self._worker is not None:
            self._worker.join(timeout_s)
            hung = self._worker.is_alive()
            if hung:
                obs.REGISTRY.inc("autosage_serve_hung_workers_total")
        self._raise_fault()
        if finalize and not hung:
            self.bs.finalize()
        stats = self.serve_stats()
        telemetry.emit_serve_event({"event": "summary", **stats}, self.bs.sage.device)
        return stats

    def __enter__(self) -> "GNNServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(finalize=exc_type is None)


# ------------------------------------------------------------ serve_gnn


def _serve_parents(n: int, regimes: int, seed: int = 0):
    """Up to 8 parent-graph regimes (mid-bin degrees and two heavy-tailed
    ones), so sampled subgraphs of one regime share a schedule bucket."""
    from repro_torch.sparse import fixed_degree, hub_skew

    parents = [fixed_degree(n, d, seed=seed + i) for i, d in enumerate((3, 6, 12, 24, 48, 96))]
    parents.append(hub_skew(n, 6, 0.10, 60, seed=seed + 6))
    parents.append(hub_skew(n, 6, 0.10, 200, seed=seed + 7))
    return parents[:max(1, min(regimes, len(parents)))]


def run_serve_gnn(
    clients: int = 4,
    requests: int = 64,
    passes: int = 2,
    f: int = 16,
    op: str = "spmm",
    regimes: int = 4,
    parent_rows: int = 2048,
    rows_per_graph: int = 256,
    budget_ms: Optional[float] = None,
    probe_budget_ms: float = 10_000.0,
    cache_path: Optional[str] = None,
    replay: bool = False,
    think_ms: float = 1.0,
    seed: int = 0,
    quiet: bool = False,
    device=None,
) -> Dict[str, Any]:
    """Drive ``clients`` concurrent request streams through one
    `GNNServer` on ``device`` (the card unless the caller asks for the
    CPU); returns the session stats. Every pass serves the same sampled
    stream, so pass 1 exercises cold admission and background upgrades,
    later passes the warm tier."""
    from repro_torch.core import ScheduleCache
    from repro_torch.sparse import sample_subgraph_stream

    parents = _serve_parents(parent_rows, regimes, seed=seed)
    stream = sample_subgraph_stream(parents, requests, rows_per_graph=rows_per_graph,
                                    seed=seed + 1)
    sage = AutoSage(cache=ScheduleCache(path=cache_path, replay_only=replay), device=device,
                    probe_iters=1, probe_cap_ms=50, probe_frac=0.25)
    bs = BatchScheduler(sage, probe_budget_ms=probe_budget_ms, auto_pump=False)
    server = GNNServer(bs, budget_ms=budget_ms)
    errors: List[BaseException] = []

    def client(cid: int) -> None:
        try:
            for g in stream[cid::clients]:
                server.submit(g, f, op)
                if think_ms > 0:
                    time.sleep(think_ms / 1e3)
        except Exception as exc:  # noqa: BLE001 - re-raised by the caller
            errors.append(exc)

    for _ in range(max(1, passes)):
        threads = [threading.Thread(target=client, args=(c,), name=f"client-{c}")
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            server.close(finalize=False)
            raise errors[0]
        # let the worker finish this pass's cold buckets, so the next
        # pass shows the warm tier
        server.drain(timeout_s=60.0)

    stats = server.close(finalize=not replay)
    if not quiet:
        print(f"[serve] {stats['requests']} requests / {clients} clients / "
              f"{stats['buckets']} buckets  budget={stats['budget_ms']:.0f}ms "
              f"device={sage.device}")
        for tier in ("warm", "transfer", "provisional", "cold"):
            n = stats["by_tier"].get(tier, 0)
            if n:
                print(f"[serve]   {tier:12s} {n}")
        print(f"[serve] latency p50={stats['p50_ms']:.3f}ms "
              f"p99={stats['p99_ms']:.3f}ms max={stats['max_ms']:.3f}ms  "
              f"stalls={stats['stalls']} over_budget={stats['over_budget']} "
              f"upgrades={stats['upgrades']}")
        for row in obs.serve_latency_table():
            tiers = ",".join(f"{t}:{n}" for t, n in row["tiers"].items())
            print(f"[serve]   bucket {row['bucket'][:48]:48s} "
                  f"n={row['requests']:<4d} p50={row['p50_ms']:.3f}ms "
                  f"p99={row['p99_ms']:.3f}ms  [{tiers}]")
    return stats


def serve_gnn_main(args: argparse.Namespace) -> int:
    stats = run_serve_gnn(
        clients=args.clients, requests=args.requests, passes=args.passes,
        f=args.f, op=args.op, regimes=args.regimes,
        rows_per_graph=args.rows, budget_ms=args.budget_ms,
        probe_budget_ms=args.probe_budget_ms, cache_path=args.cache,
        replay=args.replay, think_ms=args.think_ms, seed=args.seed,
        device=args.device,
    )
    return 0 if stats["stalls"] == 0 else 1


# -------------------------------------------------------------- demo-lm


def demo_lm_main(args: argparse.Namespace) -> int:
    """LLM serving demo: prefill a batch of prompts, then decode greedily.
    Weights and prompts come from a torch.Generator seeded with
    ``--seed`` (JAX's demo draws them from jax.random, so the
    generations differ)."""
    from repro_torch.configs.base import get_config, reduced as reduce_cfg
    from repro_torch.core.features import resolve_device
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import batch_axes_for, localize, storage_specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.train.step import make_decode_step, make_prefill_step

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    mesh = None
    if collectives.launched():
        mesh = make_host_mesh(args.device)
        device = collectives.rank_device(args.device)
    else:
        device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = api.init_model(cfg, gen, torch.float32)
    max_len = args.prompt_len + args.gen

    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen,
                            device=device)
    batch = {"tokens": prompts}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn((args.batch, cfg.vlm_patches, cfg.d_model),
                                            generator=gen, device=device)
    if cfg.family == "audio":
        batch["frames"] = torch.randn((args.batch, cfg.enc_dec.enc_seq, cfg.d_model),
                                      generator=gen, device=device)
    # every row on every rank where the cache's sequence is split instead
    seq_split = (mesh is not None and args.long_ctx and cfg.family != "audio"
                 and os.environ.get("REPRO_LONG_ATTN") == "sharded")
    ba = batch_axes_for(args.batch, mesh) if mesh is not None and not seq_split else None
    if mesh is not None:
        localize(model, storage_specs(model, cfg, mesh), mesh)
        rows = collectives.rows(args.batch, mesh, ba)
        batch = {k: v[rows] for k, v in batch.items()}
    cache = api.init_cache(cfg, batch["tokens"].shape[0], max_len, torch.float32,
                           device=device)

    prefill = make_prefill_step(cfg, device=device, mesh=mesh)
    decode = make_decode_step(cfg, long_ctx=args.long_ctx, device=device, mesh=mesh)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.time()
    logits, cache = prefill(model, batch, cache)
    if seq_split:
        cache = _keep_seq_slice(cache, mesh)
    sync()
    t_prefill = time.time() - t0

    tok = torch.argmax(logits[:, -1], -1)[:, None]
    out = [tok]
    t0 = time.time()
    for _ in range(args.gen - 1):
        logits, cache = decode(model, tok, cache)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        out.append(tok)
    sync()
    t_decode = time.time() - t0

    gen_tokens = torch.cat(out, dim=1)
    if mesh is not None:
        gen_tokens = collectives.all_gather(gen_tokens, mesh, ba, dim=0)
    if collectives.rank() == 0:
        gen_tokens = gen_tokens.cpu().numpy()
        print(f"[serve] arch={cfg.name} batch={args.batch}")
        print(f"[serve] prefill {args.prompt_len} toks: {t_prefill*1e3:.1f} ms")
        print(f"[serve] decode {args.gen-1} steps: {t_decode*1e3:.1f} ms "
              f"({t_decode/max(args.gen-1, 1)*1e3:.2f} ms/tok)")
        print(f"[serve] sample generations: {gen_tokens[:, :8].tolist()}")
    return 0


def _keep_seq_slice(cache: Dict, mesh) -> Dict:
    """Each attention layer's k/v cut to this rank's slice of the sequence
    over ('data', 'model'), the layout `csr_window_attention_sharded`
    reads; other caches stay whole."""
    from repro_torch.distributed.sharding import local_block

    spec = (None, ("data", "model"), None, None)
    layers = []
    for c in cache["layers"]:
        if "k" in c and "v" in c:
            c = dict(c, k=local_block(c["k"], spec, mesh).clone(),
                     v=local_block(c["v"], spec, mesh).clone())
        layers.append(c)
    return {"layers": layers}


# ------------------------------------------------------------------ CLI

_COMMANDS = ("serve_gnn", "demo-lm")


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description=(
            "Online serving. Default subcommand: serve_gnn, concurrent client "
            "streams of sampled subgraphs answered within AUTOSAGE_SERVE_BUDGET_MS "
            "(cold probes run on a background worker, never on the request path)."
        ),
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    sg = sub.add_parser(
        "serve_gnn",
        help="serve schedule decisions to concurrent subgraph streams (the default)",
    )
    sg.add_argument("--clients", type=int, default=4, help="concurrent client threads")
    sg.add_argument("--requests", type=int, default=64,
                    help="sampled subgraphs per pass (split across clients)")
    sg.add_argument("--passes", type=int, default=2,
                    help="passes over the stream (pass 1 cold, later warm)")
    sg.add_argument("--f", type=int, default=16, help="feature width")
    sg.add_argument("--op", default="spmm", choices=("spmm", "sddmm", "attention"))
    sg.add_argument("--regimes", type=int, default=4, help="parent-graph regimes (<= 8)")
    sg.add_argument("--rows", type=int, default=256, help="rows per sampled subgraph")
    sg.add_argument("--budget-ms", type=float, default=None,
                    help="per-request decision budget "
                         "(default: AUTOSAGE_SERVE_BUDGET_MS, else 50)")
    sg.add_argument("--probe-budget-ms", type=float, default=10_000.0,
                    help="background probe budget for the whole session")
    sg.add_argument("--cache", default=None, help="schedule-cache path (default: in-memory)")
    sg.add_argument("--replay", action="store_true",
                    help="serve pinned decisions only (AUTOSAGE_REPLAY_ONLY "
                         "semantics; unseen buckets raise)")
    sg.add_argument("--think-ms", type=float, default=1.0,
                    help="client think time between requests")
    sg.add_argument("--seed", type=int, default=0)
    sg.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run here)")
    sg.set_defaults(fn=serve_gnn_main)

    lm = sub.add_parser("demo-lm", help="LLM prefill/decode serving demo")
    lm.add_argument("--arch", required=True)
    lm.add_argument("--reduced", action="store_true")
    lm.add_argument("--batch", type=int, default=4)
    lm.add_argument("--prompt-len", type=int, default=64)
    lm.add_argument("--gen", type=int, default=32)
    lm.add_argument("--long-ctx", action="store_true", help="CSR window+sink attention")
    lm.add_argument("--seed", type=int, default=0)
    lm.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run here)")
    lm.set_defaults(fn=demo_lm_main)
    return ap


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # serve_gnn is the default: bare flags (or nothing) route to it,
    # except a top-level -h/--help, which shows the subcommand overview
    if not argv:
        argv = ["serve_gnn"]
    elif argv[0] not in _COMMANDS and argv[0] not in ("-h", "--help"):
        argv.insert(0, "serve_gnn")
    args = _build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    # under torch.distributed.run, a failing rank's traceback goes into
    # the launcher's failure summary
    from torch.distributed.elastic.multiprocessing.errors import record

    rc = record(main)()
    from repro_torch.distributed import collectives

    collectives.finish()
    sys.exit(rc)
