"""Per-step critical-path analysis and straggler attribution.

Counterpart of ``horovod_tpu/telemetry/critical_path.py``; its gauges go
into the port's registry.  Input: the per-rank ``horovod_tpu.trace.v1``
span documents the launcher collected (``hvdrun --trace``).
Every collective span carries the cross-rank correlation id
``trace_id = f(name, occurrence)``, so one logical step of one
collective is simply the group of spans sharing a ``trace_id`` across
all documents.

For each step the analysis computes, on the launcher-corrected clock:

* per-rank wall time (last span end minus first span start on that
  rank) — the rank's total involvement in the step;
* the **slowest rank** (the critical path runs through it) and every
  other rank's **slack** (how long it waited on the straggler);
* the **dominant phase** on the slowest rank — which of
  negotiate / fuse / local / cross / wait the straggler actually spent
  its time in, bucketing the fine-grained span phases
  (``local_rs``/``local_ag`` -> ``local``, ``cross_ring`` -> ``cross``,
  ...);
* the step's **attributable delay**: slowest wall minus second-slowest
  wall — the wall-clock the job would save if the straggler matched the
  runner-up.  Attribution accumulates per ``(rank, phase)`` pair, so
  the report's top line reads "rank 3 loses 1.2 s in cross".

Request-scoped spans (``rpc``/``route``/``decode``/``broadcast``) are
excluded from step grouping — they have no occurrence stream — but the
serving/RPC planes still appear in the merged trace itself.

The gauges (``hvd_critical_path_*``, ``hvd_trace_step_seconds``) are the
reference's series, under its names.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from horovod_tpu_torch import telemetry
from horovod_tpu_torch.telemetry import aggregate

# Fine-grained span phase -> report bucket.  ``submit`` stays its own
# bucket (Python-side enqueue cost); ``exec`` is the single-process
# whole-op span and books as cross (it IS the transport there).
PHASE_BUCKET = {
    "submit": "submit",
    "negotiate": "negotiate",
    "coord": "negotiate",
    "fuse": "fuse",
    "local_rs": "local",
    "local_ag": "local",
    "cross_ring": "cross",
    "cross": "cross",
    "exec": "cross",
    "transport": "transport",
    "wait": "wait",
}

# Request-scoped phases: correlated by unique name, not by occurrence —
# never part of a collective step.
REQUEST_PHASES = frozenset({"rpc", "route", "decode", "broadcast"})


def analyze(reports: Dict[int, dict], top_k: int = 5) -> dict:
    """Critical-path summary over ``{rank: trace.v1 document}``.

    Returns a plain dict (JSON-ready): per-step details, per-rank slack
    and slowest counts, per-phase attributed seconds, the top-K
    ``(rank, phase)`` straggler attribution, and step-wall percentiles
    estimated through :func:`aggregate.estimate_percentiles` over the
    standard time buckets (the same estimator the merged metrics
    summary uses).
    """
    # trace_id -> rank -> [(t0, t1, phase)] on the corrected clock.
    steps: Dict[str, Dict[int, List[Tuple[float, float, str]]]] = {}
    names: Dict[str, Tuple[str, int]] = {}
    for rank, doc in reports.items():
        offset = float(doc.get("clock_offset") or 0.0)
        for s in doc.get("spans", []):
            phase = s.get("phase", "")
            if phase in REQUEST_PHASES:
                continue
            tid = s.get("trace_id")
            if not tid:
                continue
            t0 = float(s.get("t0", 0.0)) + offset
            t1 = float(s.get("t1", t0)) + offset
            steps.setdefault(tid, {}).setdefault(int(rank), []).append(
                (t0, t1, phase))
            names.setdefault(tid, (s.get("name", "?"),
                                   int(s.get("seq", 0))))

    ranks = sorted(int(r) for r in reports)
    slowest_counts: Dict[int, int] = {r: 0 for r in ranks}
    slack_seconds: Dict[int, float] = {r: 0.0 for r in ranks}
    phase_seconds: Dict[str, float] = {}
    attribution: Dict[Tuple[int, str], Dict[str, float]] = {}
    step_rows: List[dict] = []
    wall_buckets: Dict[str, int] = {}

    for tid, by_rank in steps.items():
        walls = {r: max(t1 for _, t1, _ in spans)
                 - min(t0 for t0, _, _ in spans)
                 for r, spans in by_rank.items()}
        slowest = max(walls, key=lambda r: walls[r])
        ordered = sorted(walls.values(), reverse=True)
        second = ordered[1] if len(ordered) > 1 else ordered[0]
        delay = max(walls[slowest] - second, 0.0)
        # Dominant phase: where the straggler's time actually went.
        by_bucket: Dict[str, float] = {}
        for t0, t1, phase in by_rank[slowest]:
            b = PHASE_BUCKET.get(phase, phase or "?")
            by_bucket[b] = by_bucket.get(b, 0.0) + max(t1 - t0, 0.0)
        dominant = max(by_bucket, key=lambda b: by_bucket[b]) \
            if by_bucket else "?"

        slowest_counts[slowest] = slowest_counts.get(slowest, 0) + 1
        for r, w in walls.items():
            slack_seconds[r] = slack_seconds.get(r, 0.0) + \
                max(walls[slowest] - w, 0.0)
        phase_seconds[dominant] = phase_seconds.get(dominant, 0.0) + delay
        a = attribution.setdefault((slowest, dominant),
                                   {"seconds": 0.0, "steps": 0})
        a["seconds"] += delay
        a["steps"] += 1

        step_wall = walls[slowest]
        # Bucket the wall for the shared percentile estimator.
        placed = False
        for bound in telemetry.DEFAULT_TIME_BUCKETS:
            if step_wall <= bound:
                key = repr(float(bound))
                wall_buckets[key] = wall_buckets.get(key, 0) + 1
                placed = True
                break
        if not placed:
            wall_buckets["+Inf"] = wall_buckets.get("+Inf", 0) + 1

        name, seq = names[tid]
        step_rows.append({
            "trace_id": tid, "name": name, "seq": seq,
            "wall_seconds": step_wall, "slowest_rank": slowest,
            "dominant_phase": dominant, "delay_seconds": delay,
            "ranks": sorted(walls),
        })

    step_rows.sort(key=lambda s: s["delay_seconds"], reverse=True)
    top = sorted(
        ({"rank": r, "phase": p, "seconds": v["seconds"],
          "steps": int(v["steps"])}
         for (r, p), v in attribution.items()),
        key=lambda a: a["seconds"], reverse=True)[:top_k]
    return {
        "schema": "horovod_tpu.critical_path.v1",
        "steps": len(steps),
        "ranks": ranks,
        "slowest_counts": {str(r): n for r, n in
                           sorted(slowest_counts.items())},
        "slack_seconds": {str(r): v for r, v in
                          sorted(slack_seconds.items())},
        "phase_seconds": dict(sorted(phase_seconds.items())),
        "attribution": top,
        "step_wall_percentiles": aggregate.estimate_percentiles(
            wall_buckets),
        "slowest_steps": step_rows[:max(top_k, 5)],
    }


def publish_gauges(result: dict) -> None:
    """Mirror the analysis into ``hvd_critical_path_*`` /
    ``hvd_trace_step_seconds`` gauges on the CALLING process's registry
    (the launcher, before it writes the merged metrics summary)."""
    if not telemetry.enabled():
        return
    telemetry.gauge(
        "hvd_critical_path_steps",
        "Collective steps covered by the critical-path analysis",
    ).set(float(result.get("steps", 0)))
    for r, n in result.get("slowest_counts", {}).items():
        telemetry.gauge(
            "hvd_critical_path_slowest_steps",
            "Steps on which this rank was the critical path",
            rank=str(r)).set(float(n))
    for r, v in result.get("slack_seconds", {}).items():
        telemetry.gauge(
            "hvd_critical_path_slack_seconds",
            "Total time this rank spent waiting on slower ranks",
            rank=str(r)).set(float(v))
    for p, v in result.get("phase_seconds", {}).items():
        telemetry.gauge(
            "hvd_critical_path_phase_seconds",
            "Attributable straggler delay by dominant phase",
            phase=str(p)).set(float(v))
    for q, v in result.get("step_wall_percentiles", {}).items():
        telemetry.gauge(
            "hvd_trace_step_seconds",
            "Critical-path step wall time percentile estimate",
            q=str(q)).set(float(v))


def format_report(result: dict, top_k: int = 5) -> str:
    """Human-readable straggler report for the hvdrun/hvdtrace CLI."""
    lines = [
        f"critical path: {result.get('steps', 0)} steps across ranks "
        f"{result.get('ranks', [])}"]
    pct = result.get("step_wall_percentiles") or {}
    if pct:
        lines.append("  step wall: " + "  ".join(
            f"{q}={v * 1e3:.2f}ms" for q, v in sorted(pct.items())))
    counts = result.get("slowest_counts") or {}
    if counts:
        worst = max(counts, key=lambda r: counts[r])
        lines.append(
            f"  slowest rank: {worst} (critical on {counts[worst]} of "
            f"{result.get('steps', 0)} steps)")
    slack = result.get("slack_seconds") or {}
    if slack:
        lines.append("  slack: " + "  ".join(
            f"rank{r}={v * 1e3:.2f}ms" for r, v in sorted(
                slack.items(), key=lambda kv: int(kv[0]))))
    top = (result.get("attribution") or [])[:top_k]
    if top:
        lines.append("  top straggler attribution:")
        for a in top:
            lines.append(
                f"    rank {a['rank']} / {a['phase']}: "
                f"{a['seconds'] * 1e3:.2f}ms over {a['steps']} steps")
    for s in (result.get("slowest_steps") or [])[:top_k]:
        lines.append(
            f"    worst step {s['name']}#{s['seq']}: "
            f"wall {s['wall_seconds'] * 1e3:.2f}ms on rank "
            f"{s['slowest_rank']} ({s['dominant_phase']}, "
            f"+{s['delay_seconds'] * 1e3:.2f}ms vs runner-up)")
    return "\n".join(lines)


__all__ = ["PHASE_BUCKET", "REQUEST_PHASES", "analyze",
           "publish_gauges", "format_report"]
