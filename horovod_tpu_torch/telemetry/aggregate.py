"""Cross-rank metric aggregation.

Counterpart of ``horovod_tpu/telemetry/aggregate.py``: the launcher's
merge of one ``MetricsRegistry.snapshot()`` per rank (pushed over the
RPC plane or dumped to ``HOROVOD_METRICS_FILE``) into one document:

* counters: summed across ranks;
* histograms: bucket-wise sums (every rank shares the fixed bounds —
  the registry forbids dynamic buckets exactly for this), plus summed
  ``sum``/``count``;
* gauges: point-in-time values don't sum meaningfully across ranks, so
  the merge keeps ``min``/``max``/``mean``.

The merged document never discards the per-rank snapshots — operators
debugging a skewed rank need the attribution, not just the totals.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def estimate_percentiles(buckets: Dict[str, int],
                         qs=(0.5, 0.95, 0.99)) -> Dict[str, float]:
    """Percentile estimates from a merged (non-cumulative) bucket map.

    Linear interpolation within each fixed bucket — the standard
    histogram-quantile estimate: observations are assumed uniform
    between a bucket's lower and upper bound, so the q-th rank inside a
    bucket lands a proportional fraction of the way through it.  The
    ``+Inf`` bucket has no upper bound; ranks landing there report the
    last finite bound (a deliberate under-estimate, matching Prometheus
    ``histogram_quantile``).  Returns ``{"p50": ..., ...}`` keyed by the
    requested quantiles; empty dict for an empty histogram.
    """
    finite = sorted((float(b), int(n)) for b, n in buckets.items()
                    if b not in ("+Inf", "inf", "Inf"))
    inf_n = sum(int(n) for b, n in buckets.items()
                if b in ("+Inf", "inf", "Inf"))
    total = sum(n for _, n in finite) + inf_n
    if total <= 0:
        return {}
    out: Dict[str, float] = {}
    last_finite = finite[-1][0] if finite else 0.0
    for q in qs:
        target = q * total
        seen = 0.0
        lo = 0.0
        value = last_finite
        for bound, n in finite:
            if seen + n >= target and n > 0:
                frac = (target - seen) / n
                value = lo + (bound - lo) * frac
                break
            seen += n
            lo = bound
        else:
            value = last_finite   # target fell in +Inf
        out[f"p{q * 100:g}"] = value
    return out


def _merge_values(kind: str, entries: List[dict]) -> dict:
    """Merge same-labels children from several ranks into one entry."""
    out: dict = {"labels": entries[0]["labels"]}
    if kind == "histogram":
        buckets: Dict[str, int] = {}
        for e in entries:
            for bound, n in e.get("buckets", {}).items():
                buckets[bound] = buckets.get(bound, 0) + n
        out["sum"] = sum(e.get("sum", 0.0) for e in entries)
        out["count"] = sum(e.get("count", 0) for e in entries)
        out["buckets"] = buckets
        pct = estimate_percentiles(buckets)
        if pct:
            out["percentiles"] = pct
    elif kind == "gauge":
        vals = [e.get("value", 0.0) for e in entries]
        out["min"] = min(vals)
        out["max"] = max(vals)
        out["mean"] = sum(vals) / len(vals)
    else:
        out["value"] = sum(e.get("value", 0.0) for e in entries)
    return out


def merge_snapshots(snapshots: Dict[str, dict]) -> dict:
    """Merge ``{rank_label: snapshot}`` into one aggregate snapshot.

    ``rank_label`` keys are informational ("0", "1", "launcher", ...);
    the result has the same shape as a single registry snapshot, with
    gauge entries replaced by min/max/mean summaries.
    """
    merged: Dict[str, dict] = {}
    collation: Dict[str, Dict[tuple, List[dict]]] = {}
    kinds: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for snap in snapshots.values():
        if not isinstance(snap, dict):
            continue
        for name, fam in snap.items():
            kinds.setdefault(name, fam.get("type", "counter"))
            helps.setdefault(name, fam.get("help", ""))
            by_labels = collation.setdefault(name, {})
            for entry in fam.get("values", []):
                key = tuple(sorted(entry.get("labels", {}).items()))
                by_labels.setdefault(key, []).append(entry)
    for name in sorted(collation):
        merged[name] = {
            "type": kinds[name],
            "help": helps[name],
            "values": [_merge_values(kinds[name], entries)
                       for _, entries in sorted(collation[name].items())],
        }
    return merged


def counter_total(snapshot: dict, name: str,
                  labels: Optional[Dict[str, str]] = None) -> float:
    """Sum of a counter family's values, optionally filtered to entries
    whose labels include every pair in ``labels`` (validation helper for
    tests and the CI telemetry gate)."""
    fam = snapshot.get(name)
    if not fam:
        return 0.0
    total = 0.0
    for entry in fam.get("values", []):
        got = entry.get("labels", {})
        if labels and any(got.get(k) != v for k, v in labels.items()):
            continue
        total += entry.get("value", 0.0)
    return total
