"""Synthetic data-parallel training benchmark on the GPU.

Counterpart of ``horovod_tpu/benchmark.py``: ``make_train_step``
(``:100``), ``make_bench_state`` (``:171``), ``run_synthetic_benchmark``
(``:241``), the analytic ``_step_flops`` (``:75``) and
``device_peak_tflops`` (``:60``).  The protocol is the reference
harness's: a fixed synthetic batch, warmup steps, then ``num_iters``
rounds of ``num_batches_per_iter`` steps, img/s as mean +- 1.96 sigma over
rounds.  A step is eager PyTorch: forward in train mode, mean softmax
cross-entropy, backward, the fused gradient mean over the data group, SGD
with momentum 0.9, and the step guard.  On a GPU the rounds are timed with
CUDA events; on the CPU, which runs only when the caller asks for it, with
the host clock.
"""

from __future__ import annotations

import os
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from horovod_tpu_torch import basics, resilience
from horovod_tpu_torch.models import get_model
from horovod_tpu_torch.models.convert import flax_ordered_parameters
from horovod_tpu_torch.models.resnet import space_to_depth
from horovod_tpu_torch.ops.fusion import fused_pytree_mean
from horovod_tpu_torch.topology import Mesh, data_axis, mesh_size

# Peak dense bf16 TFLOP/s per card by device-name substring (NVIDIA's data
# sheets, SXM parts, without sparsity), for MFU.  Override with
# BENCH_PEAK_TFLOPS.
PEAK_TFLOPS_BY_KIND = {
    "H100": 989.0,
    "H200": 989.0,
}

# Forward-pass GFLOPs per 224x224 image (standard analytic counts, 2 FLOPs
# per MAC); a training step is ~3x the forward.
_FWD_GFLOPS_224 = {
    "resnet18": 1.82, "resnet34": 3.67, "resnet50": 4.09,
    "resnet101": 7.80, "resnet152": 11.52,
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def device_peak_tflops(device) -> Optional[float]:
    """Peak dense bf16 TFLOP/s of ``device``, or None when unknown (the
    CPU, where MFU means nothing)."""
    env = os.environ.get("BENCH_PEAK_TFLOPS")
    if env:
        return float(env)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for kind, peak in PEAK_TFLOPS_BY_KIND.items():
        if kind in name:
            return peak
    return None


def _step_flops(model_name: str, global_bs: int,
                image_size: int) -> Optional[float]:
    """Analytic GLOBAL FLOPs of one training step (3x the forward)."""
    fwd = _FWD_GFLOPS_224.get(model_name)
    if fwd is None:
        return None
    return 3.0 * fwd * 1e9 * (image_size / 224.0) ** 2 * global_bs


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    mesh: Mesh, axis_name=None, steps_per_call: int = 1):
    """One data-parallel training step for a model with BatchNorm state.

    Returns ``step(images, labels) -> mean loss``; it updates ``model``'s
    parameters and running statistics and ``optimizer``'s momentum in
    place.  ``images``/``labels`` are this rank's shard of the batch.
    ``axis_name`` is the process group to average over (default: the
    mesh's).  ``steps_per_call`` steps run per call on the same batch.
    The step-guard policy (``HOROVOD_STEP_GUARD``) is read here, once.
    """
    group = axis_name if axis_name is not None else data_axis(mesh)
    # Gradient leaves in flax's flatten order: the reference's buckets.
    params = [p for _, p in flax_ordered_parameters(model)]
    stats = list(model.buffers())
    policy = resilience.guard_policy()

    def one_step(images, labels):
        model.train()
        saved = ([s.clone() for s in stats] if policy != "off" else None)
        logits = model(images)
        loss = F.cross_entropy(logits, labels)
        grads = torch.autograd.grad(loss, params)

        def do_update():
            mean = fused_pytree_mean(list(grads), group)
            for p, g in zip(params, mean):
                p.grad = g
            optimizer.step()
            for p in params:
                p.grad = None

        def restore():
            with torch.no_grad():
                for s, old in zip(stats, saved):
                    s.copy_(old)

        return resilience.apply_step_guard(
            do_update, loss=loss.detach(), grads=grads, restore=restore,
            group=group, policy=policy)

    def step(images, labels):
        loss = None
        for _ in range(steps_per_call):
            loss = one_step(images, labels)
        return loss

    return step


class BenchState(NamedTuple):
    mesh: Mesh
    axis: Optional[dist.ProcessGroup]
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    s2d: bool
    images: torch.Tensor       # this rank's shard, NHWC
    labels: torch.Tensor       # this rank's shard, int64


def make_bench_state(model_name: str = "resnet50", batch_size: int = 64,
                     image_size: int = 224, num_classes: int = 1000,
                     input_dtype: str = "float32", stem: str = "conv7",
                     mesh: Optional[Mesh] = None,
                     learning_rate: float = 0.01, device=None,
                     seed: int = 0) -> BenchState:
    """The benchmark-state recipe: model, optimizer and this rank's shard
    of the fixed synthetic batch.  ``batch_size`` is per rank.  Runs on
    ``cuda:<local_rank>`` unless ``device`` (or an initialized CPU world)
    says otherwise; with no GPU and no device named it raises.

    The global batch is the reference's (numpy ``default_rng(0)`` images,
    ``default_rng(1)`` labels), and rank r takes rows ``[r*bs, (r+1)*bs)``,
    as the reference's ``P(data)`` sharding does.  The model's weights come
    from ``torch.Generator().manual_seed(seed)``.
    """
    if stem not in ("conv7", "s2d", "s2d_fused"):
        raise ValueError(f"stem={stem!r}: expected 'conv7', 's2d' or "
                         f"'s2d_fused'")
    if input_dtype not in _DTYPES:
        raise ValueError(f"input_dtype={input_dtype!r}: expected one of "
                         f"{sorted(_DTYPES)}")
    if not basics.is_initialized():
        basics.init(device=device)
    mesh = mesh if mesh is not None else basics.mesh()
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device={device!r} but the mesh runs on "
                         f"{mesh.device}")
    group = data_axis(mesh)
    n, rank = mesh_size(mesh), dist.get_rank(group)
    global_bs = batch_size * n

    s2d = stem in ("s2d", "s2d_fused") and model_name.startswith("resnet")
    extra = {"stem": stem} if s2d else {}
    model = get_model(model_name, num_classes=num_classes,
                      generator=torch.Generator().manual_seed(seed),
                      device=mesh.device, **extra)
    optimizer = torch.optim.SGD(
        [p for _, p in flax_ordered_parameters(model)], lr=learning_rate,
        momentum=0.9)

    rows = slice(rank * batch_size, (rank + 1) * batch_size)
    images = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (global_bs, image_size, image_size, 3), dtype=np.float32)[rows])
    if s2d:
        images = space_to_depth(images)
    images = images.to(_DTYPES[input_dtype]).to(mesh.device).contiguous()
    labels = torch.from_numpy(np.random.default_rng(1).integers(
        0, num_classes, (global_bs,), dtype=np.int32)[rows])
    labels = labels.to(torch.int64).to(mesh.device)
    return BenchState(mesh, group, model, optimizer, s2d, images, labels)


class _Rounds:
    """Per-round timing: CUDA events on a GPU (read after the last
    round, so timing adds no host sync), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks[:-1], self.marks[1:])]
        return [b - a for a, b in zip(self.marks[:-1], self.marks[1:])]


def run_synthetic_benchmark(model_name: str = "resnet50",
                            batch_size: int = 64,
                            image_size: int = 224,
                            num_classes: int = 1000,
                            num_warmup_batches: int = 5,
                            num_batches_per_iter: int = 10,
                            num_iters: int = 10,
                            learning_rate: float = 0.01,
                            mesh: Optional[Mesh] = None,
                            input_dtype: str = "float32",
                            stem: str = "conv7",
                            device=None,
                            verbose: bool = True) -> dict:
    """Run the synthetic benchmark; returns a result dict.  ``batch_size``
    is per rank, as in the reference."""
    st = make_bench_state(model_name, batch_size, image_size=image_size,
                          num_classes=num_classes, input_dtype=input_dtype,
                          stem=stem, mesh=mesh, learning_rate=learning_rate,
                          device=device)
    dev = st.mesh.device
    n_chips = mesh_size(st.mesh)
    global_bs = batch_size * n_chips
    step = make_train_step(st.model, st.optimizer, st.mesh, st.axis)
    flops_per_step = _step_flops(model_name, global_bs, image_size)
    if verbose:
        print(f"Model: {model_name} stem={stem if st.s2d else 'conv7'}",
              flush=True)
        print(f"Batch size: {batch_size} per rank, {global_bs} global "
              f"({n_chips} rank(s) on {dev})", flush=True)

    for _ in range(num_warmup_batches):
        step(st.images, st.labels)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    rounds = _Rounds(dev)
    losses = []
    rounds.mark()
    for _ in range(num_iters):
        for _ in range(num_batches_per_iter):
            losses.append(step(st.images, st.labels))
        rounds.mark()
    secs = rounds.seconds()
    step_losses = [float(x) for x in losses]
    img_secs = [global_bs * num_batches_per_iter / dt for dt in secs]
    img_sec_mean = float(np.mean(img_secs))
    img_sec_conf = float(1.96 * np.std(img_secs))
    ms_per_step = float(np.mean(secs)) / num_batches_per_iter * 1e3

    tflops_per_chip = mfu = None
    peak = device_peak_tflops(dev)
    if flops_per_step:
        steps_per_sec = img_sec_mean / global_bs
        tflops_per_chip = flops_per_step * steps_per_sec / n_chips / 1e12
        if peak:
            mfu = tflops_per_chip / peak
    on_gpu = dev.type == "cuda"
    result = {
        "model": model_name,
        "batch_size_per_chip": batch_size,
        "stem": stem if st.s2d else "conv7",
        "n_chips": n_chips,
        "platform": "gpu" if on_gpu else "cpu",
        "device": torch.cuda.get_device_name(dev) if on_gpu else "cpu",
        "img_sec_total": img_sec_mean,
        "img_sec_conf": img_sec_conf,
        "img_sec_per_chip": img_sec_mean / n_chips,
        "ms_per_step": ms_per_step,
        "flops_per_step": flops_per_step,
        "tflops_per_chip": tflops_per_chip,
        "peak_tflops": peak,
        "mfu": mfu,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if on_gpu else None),
        "step_losses": step_losses,
        "loss": step_losses[-1] if step_losses else None,
    }
    if verbose:
        for i, v in enumerate(img_secs):
            print(f"Iter #{i}: {v:.1f} img/sec total", flush=True)
        print(f"Total img/sec on {n_chips} rank(s): {img_sec_mean:.1f} "
              f"+-{img_sec_conf:.1f} ({ms_per_step:.2f} ms/step)",
              flush=True)
        if tflops_per_chip is not None:
            mfu_s = f", MFU {mfu * 100:.2f}%" if mfu is not None else ""
            print(f"Achieved {tflops_per_chip:.2f} TFLOP/s per rank"
                  f"{mfu_s}", flush=True)
    return result


def _kernel_category(name: str) -> str:
    n = name.lower()
    if "fused_stem" in n:
        return "fused_stem"
    if "nccl" in n:
        return "collective"
    if any(k in n for k in ("conv", "cudnn", "xmma", "gemm", "wgmma",
                            "cutlass", "implicit")):
        return "conv_matmul"
    if "reduce" in n:
        return "reduction"
    if "elementwise" in n or "vectorized" in n or "cat" in n:
        return "elementwise"
    return "other"


def run_profile(model_name: str = "resnet50", batch_size: int = 64,
                image_size: int = 224, steps: int = 5,
                input_dtype: str = "bfloat16", stem: str = "s2d_fused",
                device=None, top: int = 15) -> dict:
    """Trace ``steps`` training steps with ``torch.profiler`` and return
    where the device time goes: kernel time by category and by name, and
    the device's busy share of the wall time (the union of kernel
    intervals over the host-clock window, which ends in a synchronize).
    Same state recipe as the throughput run, so the trace explains the
    program the benchmark measures.  Needs a CUDA device."""
    from torch.profiler import ProfilerActivity, profile

    st = make_bench_state(model_name, batch_size, image_size=image_size,
                          input_dtype=input_dtype, stem=stem, device=device)
    if st.mesh.device.type != "cuda":
        raise ValueError("run_profile measures device time; it needs a "
                         "CUDA device")
    step = make_train_step(st.model, st.optimizer, st.mesh, st.axis)
    for _ in range(3):
        step(st.images, st.labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(st.images, st.labels)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (end - start)
    busy, last = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > last:
            busy += end - max(start, last)
            last = end
    kernel_us = sum(by_name.values())
    by_cat: dict = {}
    for name, us in by_name.items():
        cat = _kernel_category(name)
        by_cat[cat] = by_cat.get(cat, 0.0) + us
    return {
        "model": model_name, "stem": stem, "batch_size": batch_size,
        "steps": steps,
        "device": torch.cuda.get_device_name(st.mesh.device),
        "wall_ms_per_step": wall_us / steps / 1e3,
        "kernel_ms_per_step": kernel_us / steps / 1e3,
        "device_busy_share": busy / wall_us if wall_us else None,
        "kernels_per_step": len(spans) / steps,
        "ms_per_step_by_category": {
            k: v / steps / 1e3 for k, v in sorted(
                by_cat.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [
            [name[:120], us / steps / 1e3] for name, us in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:top]],
    }


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="Trace a few training steps on the GPU and print where "
                    "the device time goes (run_profile) as JSON.")
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--stem", default="s2d_fused")
    ap.add_argument("--input-dtype", default="bfloat16")
    args = ap.parse_args()
    print(json.dumps(run_profile(
        args.model, args.batch_size, image_size=args.image_size,
        stem=args.stem, input_dtype=args.input_dtype), indent=1), flush=True)
    basics.shutdown()
