"""Inception-v3's f32 train step on the card against cuDNN's algorithms.

The study behind ``chip_smoke.py`` phase 18 (a)'s Inception-v3 limit:
whether cuDNN's convolution algorithms set how far the card's f32 step
lands from the CPU's f64 step.  (They did not: PyTorch's channels-last
CUDA backward of the 3x3/s1 average pool did; ``python3 chip_smoke.py
--avg-pool-check``.)  Run it on a GPU host from the repo's root:

    python3 inception_cudnn_study.py readings [--shapes N] \
        [--deterministic] [--benchmark]
    python3 inception_cudnn_study.py convs [--deterministic] [--benchmark]
    CUDNN_LOGLEVEL_DBG=3 CUDNN_LOGDEST_DBG=FILE \
        python3 inception_cudnn_study.py convs
    python3 inception_cudnn_study.py log FILE

``readings`` is ``chip_smoke.py --inception-readings`` under cuDNN's
flags; ``convs`` holds each convolution's three passes, with cuDNN and
without, to f64 and to the worst-case f32 bound; ``log`` counts the plans
that cuDNN's API log shows it executed, by engine and ``enable_tf32``.
"""

import json
import statistics
import sys

import torch

import chip_smoke


def _options(argv) -> tuple:
    """cuDNN's flags for the card's cuDNN runs (``--deterministic``,
    ``--benchmark``: cuDNN times its engines and keeps the fastest; TF32
    off in every case) and the first N reading shapes (``--shapes N``)."""
    argv = list(argv)
    n = (int(argv[argv.index("--shapes") + 1]) if "--shapes" in argv
         else len(chip_smoke.INCEPTION_READINGS))
    flags = {"enabled": True, "allow_tf32": False,
             "deterministic": "--deterministic" in argv,
             "benchmark": "--benchmark" in argv}
    return flags, chip_smoke.INCEPTION_READINGS[:n]


def _flag_note(flags: dict) -> str:
    return ", ".join(f"{k}={flags[k]}" for k in ("deterministic",
                                                  "benchmark"))


def readings(argv=()) -> None:
    """``chip_smoke.inception_readings`` on the first N shapes, its
    card step with cuDNN under the flags given."""
    flags, shapes = _options(argv)
    print(f"cuDNN {_flag_note(flags)}", flush=True)
    torch.backends.cudnn.deterministic = flags["deterministic"]
    torch.backends.cudnn.benchmark = flags["benchmark"]
    chip_smoke.inception_readings(shapes)


def _conv_passes(mod, x, w, gy):
    """``(y, dx, dw)`` of the port's Conv ``mod`` at input ``x``, kernel
    ``w`` and output gradient ``gy``, through autograd."""
    from torch.func import functional_call

    x = x.detach().requires_grad_(True)
    w = w.detach().requires_grad_(True)
    compute = mod.dtype
    mod.dtype = x.dtype              # Conv casts to its dtype: not here
    try:
        y = functional_call(mod, {"kernel": w}, (x,))
        dx, dw = torch.autograd.grad(y, (x, w), gy.to(x.dtype))
    finally:
        mod.dtype = compute
    return y.detach(), dx, dw


def convs(argv=()) -> None:
    """Each of Inception-v3's convolutions alone, at the first reading
    shape's train step: forward, input gradient and kernel gradient in
    f32 with cuDNN and without it (PyTorch's own CUDA convolution), each
    against f64 without cuDNN.  For every pass it prints the largest
    error over the largest truth, cuDNN's over the plain route's, and the
    largest error over the worst-case bound of any order of f32 sums,
    ``K * 2**-24 * sum|a*b|`` (the same passes on absolute values in
    f64; K = products a sum adds).  A ratio above 1 lies outside f32
    accuracy.  Flags as for :func:`readings`."""
    from horovod_tpu_torch.models import resnet

    flags, shapes = _options(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch, size, seed = shapes[0]
    rng = torch.Generator().manual_seed(seed)
    images = torch.randn(batch, size, size, 3, generator=rng).cuda()
    labels = torch.randint(0, 5, (batch,), generator=rng).cuda()
    model = chip_smoke._registered("inception3")(
        dtype=torch.float32, device="cuda",
        generator=torch.Generator().manual_seed(0))
    convs = [(n, m) for n, m in model.named_modules()
             if isinstance(m, resnet.Conv)]
    seen = {}

    def keep_input(name):
        def hook(mod, args):
            seen[name] = [args[0].detach().float()]
        return hook

    def keep_grad(name):
        def hook(mod, grad_in, grad_out):
            seen[name].append(grad_out[0].detach().float())
        return hook

    hooks = [h for n, m in convs for h in (
        m.register_forward_pre_hook(keep_input(n)),
        m.register_full_backward_hook(keep_grad(n)))]
    torch.nn.functional.cross_entropy(model(images).float(),
                                      labels).backward()
    for h in hooks:
        h.remove()
    rows = []
    for name, mod in convs:
        x, gy = seen[name]
        w = mod.kernel.detach()
        x64, w64, gy64 = x.double(), w.double(), gy.double()
        with torch.backends.cudnn.flags(enabled=False):
            truth = _conv_passes(mod, x64, w64, gy64)
            size_ = _conv_passes(mod, x64.abs(), w64.abs(), gy64.abs())
            plain = _conv_passes(mod, x, w, gy)
        with torch.backends.cudnn.flags(**flags):
            card = _conv_passes(mod, x, w, gy)
        o, i, kh, kw = w.shape
        n_products = (i * kh * kw, o * kh * kw,
                      x.shape[0] * gy.shape[2] * gy.shape[3])
        for p, label in enumerate(("fwd", "dgrad", "wgrad")):
            scale = truth[p].abs().max().item() or 1.0
            err_card = (card[p].double() - truth[p]).abs()
            err_plain = (plain[p].double() - truth[p]).abs()
            bound = n_products[p] * 2.0 ** -24 * size_[p] + 1e-300
            rows.append({
                "conv": name, "pass": label, "kernel": list(w.shape),
                "input": list(x.shape),
                "cudnn_rel": err_card.max().item() / scale,
                "plain_rel": err_plain.max().item() / scale,
                "cudnn_over_bound": (err_card / bound).max().item(),
                "plain_over_bound": (err_plain / bound).max().item()})
    for r in rows:
        r["ratio"] = r["cudnn_rel"] / max(r["plain_rel"], 1e-300)
    rows.sort(key=lambda r: -r["ratio"])
    outside = [r for r in rows if r["cudnn_over_bound"] > 1.0]
    print(f"Inception-v3 convolutions at {size}x{size} batch {batch} seed "
          f"{seed}, cuDNN {_flag_note(flags)}: {len(convs)} "
          f"convolutions x 3 passes; {len(outside)} cuDNN passes and "
          f"{sum(r['plain_over_bound'] > 1.0 for r in rows)} plain passes "
          f"above the f32 bound; median cuDNN/plain error ratio "
          f"{statistics.median(r['ratio'] for r in rows):.3g}", flush=True)
    for r in rows[:12]:
        print("  " + json.dumps(r), flush=True)
    for r in outside[:12]:
        print("  outside f32 accuracy: " + json.dumps(r), flush=True)
    by_pass = {}
    for r in rows:
        by_pass.setdefault(r["pass"], []).append(r["ratio"])
    print("  cuDNN/plain error ratio by pass (median, max): " + json.dumps(
        {k: [statistics.median(v), max(v)] for k, v in by_pass.items()}),
        flush=True)


def log_summary(path: str) -> None:
    """Read cuDNN's API log (``CUDNN_LOGLEVEL_DBG=3``, written to
    ``path``) and count each executed plan by operation, tensor shapes,
    engine, knobs and the ``enable_tf32`` that cuDNN ran it with; then
    the same counts by operation, engine and ``enable_tf32`` alone, with
    the numerical notes the log's engine descriptors give each engine
    (the heuristics' listings carry them; an executed plan's do not)."""
    import collections
    import re

    plans = collections.Counter()
    notes = collections.defaultdict(set)
    note_rx = re.compile(r"CUDNN_NUMERICAL_NOTE_(\w+): type=bool; val=true")
    op_rx = re.compile(r"CUDNN_BACKEND_OPERATION_(\w+)_DESCRIPTOR")
    engine_rx = re.compile(r"engine_id: type=int; val=(-?\d+)")
    last_op, noted = None, None
    block, pending, rec = None, None, {}
    header = re.compile(r"^I! CuDNN .* function (cudnn\w+)\(\) called")
    fields = (("op", re.compile(r"CUDNN_BACKEND_OPERATION_(\w+)_DESCRIPTOR")),
              ("dims", re.compile(r"dimA: type=int; val=\[([-\d,]+)\]")),
              ("engine", re.compile(r"engine_id: type=int; val=(-?\d+)")),
              ("knob", re.compile(r"CUDNN_KNOB_TYPE_(\w+): type=int; "
                                  r"val=(-?\d+)")),
              ("tf32", re.compile(r"enable_tf32: type=bool; val=(\w+)")))

    def close():
        nonlocal pending
        if block == "cudnnBackendExecute" and rec.get("op"):
            pending = (rec["op"][0], tuple(rec.get("dims", [])[:3]),
                       (rec.get("engine") or ["?"])[0],
                       tuple(rec.get("knob", [])))
        elif block == "cudnnBackendExecuteInternal" and pending:
            plans[pending + ((rec.get("tf32") or ["?"])[0],)] += 1
            pending = None

    with open(path, errors="replace") as f:
        for line in f:
            hit = op_rx.search(line)
            if hit:
                last_op = hit.group(1)
            hit = engine_rx.search(line)
            if hit:
                noted = (last_op, hit.group(1))
                notes[noted]
            elif noted is not None:
                hit = note_rx.search(line)
                if hit:
                    notes[noted].add(hit.group(1))
                elif "behaviorNotes" in line:
                    noted = None
            m = header.match(line)
            if m:
                close()
                block, rec = m.group(1), {}
                continue
            if block not in ("cudnnBackendExecute",
                             "cudnnBackendExecuteInternal"):
                continue
            for key, rx in fields:
                hit = rx.search(line)
                if hit:
                    value = ("=".join(hit.groups()) if key == "knob"
                             else hit.group(1))
                    rec.setdefault(key, []).append(value)
    close()
    by_engine = collections.Counter()
    for (op, _, engine, _, tf32), n in plans.items():
        by_engine[(op, engine, tf32)] += n
    print(f"cuDNN API log {path}: {sum(plans.values())} executions of "
          f"{len(plans)} plans", flush=True)
    for (op, engine, tf32), n in sorted(by_engine.items()):
        print(f"  {op} engine {engine} enable_tf32={tf32}: {n}; numerical "
              f"notes {sorted(notes.get((op, engine), ())) or 'none seen'}",
              flush=True)
    for (op, dims, engine, knobs, tf32), n in sorted(plans.items()):
        print("  " + json.dumps({"op": op, "dims": dims, "engine": engine,
                                 "knobs": knobs, "enable_tf32": tf32,
                                 "executions": n}), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("the study needs a CUDA device")
    mode = sys.argv[1:2]
    if mode == ["readings"]:
        readings(sys.argv[2:])
    elif mode == ["convs"]:
        convs(sys.argv[2:])
    elif mode == ["log"] and len(sys.argv) == 3:
        log_summary(sys.argv[2])
    else:
        sys.exit(__doc__)
