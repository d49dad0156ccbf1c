"""End-to-end run of the PyTorch port: serve an online stream of
requests with the EconoServe scheduler on one engine or an N-instance
fleet (``--cluster N``), optionally disaggregated into prefill / decode
roles with live KV migration (``--disagg``), under scripted faults.

Requests arrive online (Poisson gaps on the iteration clock) through the
submit/step loop, and the report includes per-request TTFT beside
throughput. The engines run on the card unless ``--device cpu`` is given.

``--chaos SPEC`` injects scripted faults into a cluster run: ``kill@25:1``
(kill instance 1 at t=25), ``freeze@40:2/20``, ``slow@10:0/30x3``,
``corrupt@15`` (corrupt the next KV migration; the inject-side checksum
catches it), ``squeeze@20:0/0.5`` (drop half of instance 0's KVC capacity
for good; pair with ``--kvc-tokens`` so the cut bites). A fault-free
reference run on the same weights is served first, and the chaotic run
must reproduce its greedy token streams bit for bit while every request
reaches exactly one terminal state (``check_fleet_invariants``); a
request shed by rung 4 of the pressure ladder (``kvc-infeasible``) is
exempt from the stream gate. ``--detect`` routes every message through a
seeded lossy transport with heartbeat/lease failure detection and arms the
fleet's shed-retry tier; the transport kinds ``drop@``, ``dup@``,
``delay@`` and ``part@`` need it. ``--hedge`` races stalled requests on a
live peer (first terminal transition wins) and, under chaos, requires at
least one hedge to win. ``--metrics PATH`` attaches a ``MetricsSampler``
to every engine and writes ``PATH.json`` and ``PATH.prom`` at exit (the
Prometheus text is parsed back as a self-check). Exit code 1 when a gate
fails.

  python -m repro_torch.launch.serve_trace --tiny --cluster 2 --disagg
  python -m repro_torch.launch.serve_trace --device cpu --tiny \\
      --cluster 3 --chaos kill@25:1
  python -m repro_torch.launch.serve_trace --tiny --cluster 3 --detect \\
      --chaos "drop@6:1/0.6,dup@14:2/0.6,kill@25:0"
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.cluster import (DetectorConfig, EngineFleet, HedgeConfig,
                                 RecoveryConfig, ROUTERS, FaultInjector,
                                 check_fleet_invariants, parse_chaos_spec)
from repro_torch.configs import get_config
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.obs import (MetricsRegistry, MetricsSampler,
                             parse_prometheus_text, write_json_snapshot,
                             write_prometheus)
from repro_torch.serving import GenRequest, SamplingParams, ServingEngine


def hist_quantile(h, q):
    """Bucket-resolution quantile from a HistogramValue snapshot (the
    first edge whose cumulative count covers the target rank)."""
    target = q * h.count
    for le, cum in h.buckets:
        if cum >= target:
            return le
    return float("inf")


def make_requests(cfg, n, rate, seed):
    rng = np.random.default_rng(seed)
    reqs = [GenRequest(
        prompt=[int(t) for t in rng.integers(0, cfg.vocab_size,
                                             rng.integers(6, 40))],
        params=SamplingParams(max_new_tokens=int(rng.integers(4, 16)),
                              temperature=0.0))
        for _ in range(n)]
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    return reqs, arrivals


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("-n", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--variant", default="full",
                    help="econoserve variant: d|sd|sdo|full")
    ap.add_argument("--cluster", type=int, default=0, metavar="N",
                    help="serve across N engine instances (0 = single)")
    ap.add_argument("--router", default="least-kvc", choices=list(ROUTERS))
    ap.add_argument("--disagg", action="store_true",
                    help="engine 0 prefills, the rest decode (KV "
                         "migration); requires --cluster >= 2")
    ap.add_argument("--chaos", default="", metavar="SPEC",
                    help="scripted fault schedule, e.g. 'kill@25:1,"
                         "freeze@40:2/20,corrupt@15,squeeze@20:0/0.5'; "
                         "drop@/dup@/delay@/part@ need --detect; requires "
                         "--cluster >= 2")
    ap.add_argument("--detect", action="store_true",
                    help="heartbeat/lease failure detection over a lossy "
                         "transport, plus the fleet shed-retry tier")
    ap.add_argument("--hedge", action="store_true",
                    help="hedged execution of stalled requests; requires "
                         "--detect")
    ap.add_argument("--hedge-factor", type=float, default=3.0,
                    help="stall threshold as a multiple of the rolling "
                         "p90 of observed TTFT / inter-token gaps")
    ap.add_argument("--hedge-floor", type=float, default=4.0,
                    help="minimum stall threshold in iterations")
    ap.add_argument("--kvc-tokens", type=int, default=0,
                    help="per-instance KVC budget in tokens (0 = "
                         "max_batch * capacity)")
    ap.add_argument("--metrics", default="", metavar="PATH",
                    help="attach metrics samplers and write PATH.json + "
                         "PATH.prom at exit")
    ap.add_argument("--rate", type=float, default=0.5,
                    help="mean arrivals per engine iteration")
    ap.add_argument("--tiny", action="store_true",
                    help="test-sized model (d_model 64, vocab 256)")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    if args.disagg and args.cluster < 2:
        ap.error("--disagg needs --cluster >= 2")
    if args.chaos and args.cluster < 2:
        ap.error("--chaos needs --cluster >= 2 (a fleet to degrade)")
    if args.detect and args.cluster < 2:
        ap.error("--detect needs --cluster >= 2 (a fleet to observe)")
    if args.hedge and not args.detect:
        ap.error("--hedge needs --detect")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = get_config(args.arch).reduced().with_(dtype="float32",
                                                param_dtype="float32")
    if args.tiny:
        cfg = cfg.with_(d_model=64, num_heads=2, num_kv_heads=2,
                        head_dim=32, d_ff=256, vocab_size=256)
    kw = dict(max_batch=6, capacity=160, variant=args.variant,
              device=args.device)
    if args.kvc_tokens:
        kw["scheduler_cfg"] = SchedulerConfig(
            kvc_tokens=args.kvc_tokens, block_size=32, tfs=160,
            max_model_len=160, max_batch_reqs=6)
    n_inst = max(0, args.cluster)
    fkw = {}
    if args.chaos:
        fkw = dict(faults=FaultInjector(
                       schedule=parse_chaos_spec(args.chaos, n_inst)),
                   recovery=RecoveryConfig(max_retries=4, backoff_base=1.0,
                                           shed_retry=args.detect))
    if args.detect:
        fkw["detector"] = DetectorConfig()
        fkw.setdefault("recovery",
                       RecoveryConfig(max_retries=4, backoff_base=1.0,
                                      shed_retry=True))
    if args.hedge:
        fkw["hedge"] = HedgeConfig(ttft_factor=args.hedge_factor,
                                   rate_factor=args.hedge_factor,
                                   floor=args.hedge_floor)
    if n_inst:
        roles = ["prefill"] + ["decode"] * (n_inst - 1) if args.disagg \
            else None
        server = EngineFleet(cfg, n_instances=n_inst, roles=roles,
                             router=args.router, seed=args.seed, **fkw, **kw)
    else:
        server = ServingEngine(cfg, seed=args.seed, **kw)

    reg = MetricsRegistry()
    if args.metrics:
        if isinstance(server, EngineFleet):
            server.attach_metrics(reg)
        else:
            MetricsSampler(reg, instance="0").attach(server)

    ref_out = None
    if args.chaos:
        # fault-free reference on the same weights: the chaotic run's
        # recovered token streams must match it bit for bit
        ref_reqs, ref_arr = make_requests(cfg, args.n, args.rate, args.seed)
        ref = ServingEngine(cfg, params=server.params, seed=args.seed, **kw)
        ref.run(ref_reqs, ref_arr)
        ref_out = [g.output for g in ref_reqs]

    reqs, arrivals = make_requests(cfg, args.n, args.rate, args.seed)
    t0 = time.time()
    server.run(reqs, arrivals)
    dt = time.time() - t0

    toks = sum(len(g.output) for g in reqs)
    done = sum(g.t_done is not None for g in reqs)
    if isinstance(server, EngineFleet):
        completed = server.completed_requests()
        cons = server.conservation()
        extra = (f"cluster={n_inst} router={args.router} "
                 f"migrations={cons['migrations']} "
                 f"conservation_ok={cons['ok']}")
        iids = [str(i.id) for i in server.instances]
    else:
        completed = server.scheduler.completed
        cons = None
        extra = "single-engine"
        iids = ["0"]
    device = server.device

    # the per-request report is read back from a registry snapshot, the
    # path debug_state and the --metrics dumps use
    server.publish_metrics(reg)
    ttft_h = reg.histogram(
        "report_ttft_iterations", "per-request time to first token on "
        "the iteration clock", buckets=(1, 2, 5, 10, 25, 50, 100, 250))
    for r in completed:
        if r.t_first_token is not None:
            ttft_h.unlabeled.observe(r.t_first_token - r.arrival)
    reg.gauge("report_served_requests",
              "requests that reached DONE").unlabeled.set(done)
    reg.gauge("report_generated_tokens",
              "tokens generated across all requests").unlabeled.set(toks)
    reg.gauge("report_wall_seconds", "serve wall time").unlabeled.set(dt)
    snap = reg.snapshot()

    ttft = snap.get("report_ttft_iterations")
    print(f"arch={cfg.name} device={device} variant={args.variant} {extra}")
    print(f"served {done}/{args.n} requests / {toks} tokens in {dt:.1f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s on {device})")
    if ttft.count:
        print(f"TTFT (iterations): mean={ttft.sum / ttft.count:.1f} "
              f"p50<={hist_quantile(ttft, 0.5):.0f} "
              f"p95<={hist_quantile(ttft, 0.95):.0f}")
    fails = sum(snap.get("kvc_alloc_failures_total", instance=i) or 0
                for i in iids)
    fracs = [round(snap.get("kvc_allocated_frac", instance=i) or 0.0, 2)
             for i in iids]
    print(f"KVC accounting: failures={fails:.0f}, alloc_frac={fracs}")

    if args.metrics:
        write_json_snapshot(snap, args.metrics + ".json",
                            extra={"argv": vars(args)})
        write_prometheus(snap, args.metrics + ".prom")
        with open(args.metrics + ".prom") as fh:
            parse_prometheus_text(fh.read())     # export self-check
        n_sampled = sum(snap.get("sampler_samples_total", instance=i) or 0
                        for i in iids)
        print(f"metrics: wrote {args.metrics}.json / .prom "
              f"({n_sampled:.0f} sampler ticks)")

    if args.hedge:
        hc = server.hedge.counters()
        print(f"hedge: fired={hc['hedges_fired']} won={hc['hedges_won']} "
              f"cancelled={hc['hedges_cancelled']} "
              f"fenced={server.n_fenced_completions} "
              f"stale_drops={server.n_stale_drops}")

    if not args.chaos:
        return 0 if done == args.n else 1
    report = check_fleet_invariants(server, strict=False)
    # rung 4 may shed permanently infeasible requests; every surviving
    # stream must still match the fault-free run
    equal = all(g.output == r for g, r in zip(reqs, ref_out)
                if g.status != "shed")
    print(f"chaos: faults={server.faults.log} "
          f"recovered={server.n_recovered} "
          f"aborted={cons['aborted']} shed={cons['shed']} "
          f"kv_rejects={cons['kv_rejects']} "
          f"invariants_ok={report['ok']} tokens_equal={equal}")
    if args.detect:
        tr = server.transport
        print(f"detect: transitions={server.detector.transitions} "
              f"reinstated={server.detector.n_reinstated} "
              f"dropped={tr.n_dropped} duplicated={tr.n_duplicated} "
              f"retransmits={tr.n_retransmits} "
              f"dup_suppressed={cons['dup_deliveries']} "
              f"shed_rescued={cons['shed_rescued']}")
    if report["problems"]:
        print(f"invariant problems: {report['problems']}")
    if not (cons["ok"] and report["ok"] and equal):
        return 1
    if args.hedge and server.hedge.counters()["hedges_won"] < 1:
        # the schedule was chosen to make hedging matter: a run where no
        # clone beat its primary means the tier never engaged
        return 1
    return 0 if done + cons["aborted"] + cons["shed"] == args.n else 1


if __name__ == "__main__":
    raise SystemExit(main())
