"""Device-side profiling: where a step's kernel time goes, from a trace.

Counterpart of ``horovod_tpu/utils/profiling.py`` on ``torch.profiler``:
run a traced step (:func:`trace_once`), read one device track of the
Chrome trace (:func:`device_op_durations`), and add the kernel times up
by category (:func:`by_category`) and by model layer (:func:`by_layer`).
:func:`trace_steps` is what ``benchmark.run_profile``,
``run_lm_profile`` and ``run_decode_profile`` measure with.

Two layouts of trace are read, gzipped or not: torch's export, whose
device events carry ``"cat": "kernel"`` (or ``gpu_memcpy``,
``gpu_memset``), and the reference's trace-viewer layout, whose device
track is a process named with ``GPU`` or ``/device:``.

Layers: torch's trace keeps host ops and kernels on separate tracks,
joined by correlation ids (a kernel's ``args.correlation`` is that of the
``cudaLaunchKernel`` runtime event on the launching thread).  Module
scopes (``nn.Module: Conv_3``) appear in the trace only when the
profiler records the Python stack, so :func:`trace_once` with
``layers=True`` profiles ``with_stack=True`` and ``with_modules=True``;
that costs host time, which is why :func:`trace_steps` takes its busy
share from a trace without them.  A kernel launched inside an autograd
node (``autograd::engine::evaluate_function``, on the backward thread)
counts as ``bwd`` and goes to the layer whose forward op has the node's
sequence number.
"""

from __future__ import annotations

import collections
import gzip
import json
import os
import re
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

# Event categories of torch's export that run on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_MODULE_PREFIX = "nn.Module: "
_BACKWARD_NODE = "autograd::engine::evaluate_function"


def trace_once(run: Callable[[], None], trace_dir: Optional[str] = None,
               layers: bool = False) -> str:
    """Run ``run()`` under ``torch.profiler`` (host and, when a card is
    present, CUDA activities); returns the path of the Chrome trace it
    exported.  ``layers`` records the module scopes :func:`by_layer`
    reads."""
    from torch.profiler import ProfilerActivity, profile

    trace_dir = trace_dir or tempfile.mkdtemp(prefix="hvd_trace_")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, with_stack=layers,
                 with_modules=layers) as prof:
        run()
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


def _load(trace) -> dict:
    """A trace document from a path (gzipped or not) or as given."""
    if isinstance(trace, dict):
        return trace
    with open(trace, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return json.loads(raw)


def _device_events(tr: dict) -> List[dict]:
    """The complete events of one device track (on a mesh every device
    runs the same program, so one track is the step's time)."""
    events = tr["traceEvents"]
    torch_events = [e for e in events if e.get("ph") == "X"
                    and e.get("cat") in DEVICE_CATS]
    if torch_events:
        pid = min({e["pid"] for e in torch_events}, key=str)
        return [e for e in torch_events if e["pid"] == pid]
    pids = {e["pid"]: e["args"].get("name", "") for e in events
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    dev_pids = sorted(p for p, n in pids.items()
                      if "GPU" in n or "/device:" in n)
    if not dev_pids:
        raise RuntimeError(
            f"trace has no device track (processes: {sorted(pids.values())})"
            f"; a trace taken without a card holds host events only")
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("pid") == dev_pids[0]:
            name = e["name"]
            if name == "0" or name.startswith(("jit_", "while")):
                continue   # container frames, not ops
            out.append(e)
    return out


def device_op_durations(trace) -> Dict[str, Tuple[float, int]]:
    """``{op name: (total us, count)}`` over one device track of a trace
    (a path or a loaded document)."""
    agg: Dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for e in _device_events(_load(trace)):
        a = agg[e["name"]]
        a[0] += e.get("dur", 0.0)
        a[1] += 1
    return {k: (v[0], v[1]) for k, v in agg.items()}


def _numbered_family(name: str) -> str:
    return re.sub(r"\.\d+$", "", name)


def by_category(durs: Dict[str, Tuple[float, int]],
                category: Callable[[str], str] = _numbered_family):
    """``[(category, total us)]``, largest first.  The default category
    is the reference's: the name minus a trailing ``.N``;
    :func:`kernel_category` is the port's for CUDA kernels."""
    agg: Dict[str, float] = collections.defaultdict(float)
    for name, (us, _) in durs.items():
        agg[category(name)] += us
    return sorted(agg.items(), key=lambda kv: -kv[1])


def kernel_category(name: str) -> str:
    """The category of a CUDA kernel by its name: the port's own kernels,
    collectives, convolutions and matmuls, reductions, elementwise."""
    n = name.lower()
    if "fused_stem" in n:
        return "fused_stem"
    if any(k in n for k in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                            "flash_bwd_dkv_kernel", "flash_f32_fwd_kernel",
                            "flash_f32_dq_kernel", "flash_f32_dkv_kernel")
           ) and "pytorch" not in n:
        return "flash_attention"
    if "nccl" in n:
        return "collective"
    if any(k in n for k in ("conv", "cudnn", "xmma", "gemm", "wgmma",
                            "cutlass", "implicit", "nvjet")):
        return "conv_matmul"
    if "reduce" in n:
        return "reduction"
    if "elementwise" in n or "vectorized" in n or "cat" in n:
        return "elementwise"
    return "other"


# The port's layer modules (models/resnet, vgg, inception, transformer)
# and torch's own: the innermost scope that matches names the layer.
DEFAULT_LAYER_PATTERN = (
    r"^(Conv|Dense|BatchNorm|FusedStemNorm|ConvBN|BottleneckBlock|"
    r"BasicBlock|Inception[A-E]|_Layer|Linear|Conv[123]d|BatchNorm[123]d|"
    r"LayerNorm|Embedding)_\d+$")


def _enclosing(intervals, queries) -> Dict:
    """For each ``(t, key)`` query, the ``(t0, t1, payload)`` intervals
    (nested, on one thread) that contain ``t``, outermost first."""
    marks = []
    for i, (t0, t1, _) in enumerate(intervals):
        # At one instant: outer scopes open first and close last.
        marks.append((t0, 0, -t1, i))
        marks.append((t1, 2, -t0, i))
    for t, key in queries:
        marks.append((t, 1, 0.0, key))
    marks.sort(key=lambda m: m[:3])
    open_, out = [], {}
    for _, kind, _, x in marks:
        if kind == 0:
            open_.append(x)
        elif kind == 2:
            open_.remove(x)
        else:
            out[x] = [intervals[i][2] for i in open_]
    return out


def by_layer(trace, pattern: str = DEFAULT_LAYER_PATTERN):
    """``[((layer, direction), total us)]``, largest first, from a torch
    trace taken with ``trace_once(..., layers=True)``.

    A kernel goes to the innermost ``nn.Module`` scope matching
    ``pattern`` around the host event that launched it (``other`` when
    none does), ``fwd``; launched inside an autograd node, to the scope
    of the forward op with the node's sequence number, ``bwd``.  A
    kernel whose launch is not in the trace is ``("untracked", "?")``.
    Every kernel of the device track counts once, so the total equals
    :func:`device_op_durations`'."""
    tr = _load(trace)
    rx = re.compile(pattern)
    kernels = _device_events(tr)
    launches: Dict = {}
    scopes = collections.defaultdict(list)
    ops = collections.defaultdict(list)
    for e in tr["traceEvents"]:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        where = (e.get("pid"), e.get("tid"))
        t0 = float(e.get("ts", 0.0))
        t1 = t0 + float(e.get("dur", 0.0))
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (where, t0)
        elif cat == "python_function" and e["name"].startswith(
                _MODULE_PREFIX):
            scopes[where].append((t0, t1, e["name"][len(_MODULE_PREFIX):]))
        elif cat == "cpu_op":
            ops[where].append((t0, t1, (e["name"], args)))

    # The first (forward) op of each autograd sequence number.
    first_fwd: Dict[int, tuple] = {}
    for where, items in ops.items():
        for t0, _, (name, args) in items:
            seq = args.get("Sequence number")
            if seq is None or name.startswith(_BACKWARD_NODE):
                continue
            if seq not in first_fwd or t0 < first_fwd[seq][1]:
                first_fwd[seq] = (where, t0)

    def queries_by_thread(points):
        by = collections.defaultdict(list)
        for key, (where, t) in points.items():
            by[where].append((t, key))
        return by

    def enclosing(table, points):
        out = {}
        for where, qs in queries_by_thread(points).items():
            out.update(_enclosing(table.get(where, []), qs))
        return out

    used = {k.get("args", {}).get("correlation") for k in kernels}
    launch_at = {c: launches[c] for c in used if c in launches}
    node_of = {}
    for corr, chain in enclosing(ops, launch_at).items():
        nodes = [args for name, args in chain
                 if name.startswith(_BACKWARD_NODE)]
        if nodes:
            node_of[corr] = nodes[-1].get("Sequence number")
    fwd_at = {("seq", s): first_fwd[s] for s in set(node_of.values())
              if s in first_fwd}
    scope_of = enclosing(scopes, {**launch_at, **fwd_at})

    def layer(chain) -> str:
        for name in reversed(chain or []):
            if rx.search(name):
                return name
        return "other"

    agg: Dict[Tuple[str, str], float] = collections.defaultdict(float)
    for k in kernels:
        corr = k.get("args", {}).get("correlation")
        if corr not in launch_at:
            key = ("untracked", "?")
        elif corr in node_of:
            key = (layer(scope_of.get(("seq", node_of[corr]))), "bwd")
        else:
            key = (layer(scope_of.get(corr)), "fwd")
        agg[key] += k.get("dur", 0.0)
    return sorted(agg.items(), key=lambda kv: -kv[1])


def unlayered_shares(layers) -> Tuple[float, float]:
    """``(other, untracked)``: the shares of :func:`by_layer`'s total
    that reached no layer scope, and whose launch was not in the trace."""
    total = sum(us for _, us in layers)

    def share(layer):
        return (sum(us for (name, _), us in layers if name == layer)
                / total if total else 0.0)

    return share("other"), share("untracked")


def print_profile(trace_file, steps: int = 1, top: int = 20,
                  layers: bool = False) -> None:
    """Human-readable summary: the top categories (and with ``layers``,
    the top layers of a ``layers=True`` trace), per step."""
    durs = device_op_durations(trace_file)
    total = sum(us for us, _ in durs.values())
    if total == 0:
        print(f"device time: 0.00 ms/step — trace {trace_file} contains "
              f"no timed device ops ({len(durs)} op rows, all with zero "
              f"duration); capture the trace around at least one "
              f"executed step")
        return
    print(f"device time: {total / steps / 1e3:.2f} ms/step "
          f"({len(durs)} distinct ops)")
    print("-- by fusion category --")
    for cat, us in by_category(durs)[:top]:
        print(f"  {us / steps / 1e3:9.3f} ms  {100 * us / total:5.1f}%  "
              f"{cat}")
    if layers:
        print("-- by model layer (fwd/bwd) --")
        for (lay, d), us in by_layer(trace_file)[:top]:
            print(f"  {us / steps / 1e3:9.3f} ms  {100 * us / total:5.1f}%  "
                  f"{lay} [{d}]")


def _busy_us(events: List[dict]) -> float:
    """The union of the events' intervals, in us."""
    busy, last = 0.0, float("-inf")
    for start, end in sorted((float(e["ts"]), float(e["ts"]) + e.get(
            "dur", 0.0)) for e in events):
        if end > last:
            busy += end - max(start, last)
            last = end
    return busy


def _traced(step_once, steps: int, layers: bool):
    """``(trace document, host wall us)`` of ``steps`` traced steps; the
    window ends in a synchronize."""
    wall = {}

    def run():
        t0 = time.perf_counter()
        for _ in range(steps):
            step_once()
        torch.cuda.synchronize()
        wall["us"] = (time.perf_counter() - t0) * 1e6

    trace_dir = tempfile.mkdtemp(prefix="hvd_trace_")
    try:
        tr = _load(trace_once(run, trace_dir, layers=layers))
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    return tr, wall["us"]


def trace_steps(step_once, dev: torch.device, steps: int, top: int,
                layers: bool = False) -> dict:
    """Run ``step_once`` 3 times untraced, then ``steps`` times under
    ``torch.profiler``; returns where the device time went: kernel time
    by :func:`kernel_category` and by name, and the device's busy share
    of the wall time (the union of kernel intervals over the host-clock
    window).  With ``layers``, ``steps`` more steps are traced with
    module scopes for :func:`by_layer`'s top layers, beside that trace's
    own kernel total and the shares of it that reach no layer: ``other``
    (launched outside every layer scope) and ``untracked`` (its launch not
    in the trace).  That trace's busy share is not taken: the stack
    recording slows the host."""
    if dev.type != "cuda":
        raise ValueError("the profile measures device time; it needs a "
                         "CUDA device")
    for _ in range(3):
        step_once()
    torch.cuda.synchronize()
    tr, wall_us = _traced(step_once, steps, layers=False)
    events = _device_events(tr)
    durs = device_op_durations(tr)
    kernel_us = sum(us for us, _ in durs.values())
    out = {
        "steps": steps,
        "device": torch.cuda.get_device_name(dev),
        "wall_ms_per_step": wall_us / steps / 1e3,
        "kernel_ms_per_step": kernel_us / steps / 1e3,
        "device_busy_share": _busy_us(events) / wall_us if wall_us else None,
        "kernels_per_step": len(events) / steps,
        "ms_per_step_by_category": {
            k: v / steps / 1e3 for k, v in by_category(durs,
                                                       kernel_category)},
        "top_kernels_ms_per_step": [
            [name[:120], us / steps / 1e3] for name, (us, _) in sorted(
                durs.items(), key=lambda kv: -kv[1][0])[:top]],
    }
    if layers:
        tr, _ = _traced(step_once, steps, layers=True)
        lay = by_layer(tr)
        other, untracked = unlayered_shares(lay)
        out["layers"] = {
            "top_ms_per_step": [[name, d, us / steps / 1e3]
                                for (name, d), us in lay[:top]],
            "layer_total_ms_per_step": sum(us for _, us in lay)
            / steps / 1e3,
            "other_share": other,
            "untracked_share": untracked,
        }
    return out


__all__ = ["DEFAULT_LAYER_PATTERN", "DEVICE_CATS", "by_category",
           "by_layer", "device_op_durations", "kernel_category",
           "print_profile", "trace_once", "trace_steps",
           "unlayered_shares"]
