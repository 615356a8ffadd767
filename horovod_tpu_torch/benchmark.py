"""Synthetic data-parallel training benchmark on the GPU.

Counterpart of ``horovod_tpu/benchmark.py``: ``make_train_step``
(``:100``), ``make_bench_state`` (``:171``), ``run_synthetic_benchmark``
(``:241``), the analytic ``_step_flops`` (``:75``) and
``device_peak_tflops`` (``:60``), and the lanes built on them:
``run_scaling_efficiency`` (``:644``, weak scaling from one rank a host
to every rank) and ``run_step_guard_benchmark`` (``:745``, the step
guard's overhead).  The protocol is the reference
harness's: a fixed synthetic batch, warmup steps, then ``num_iters``
rounds of ``num_batches_per_iter`` steps, img/s as mean +- 1.96 sigma over
rounds.  A step is eager PyTorch: forward in train mode, mean softmax
cross-entropy, backward, the fused gradient mean over the data group, SGD
with momentum 0.9, and the step guard.  On a GPU the rounds are timed with
CUDA events; on the CPU, which runs only when the caller asks for it, with
the host clock.

The transformer LM's harness is the counterpart of ``lm_train_flops``
(``:428``) and ``run_lm_benchmark`` (``:443``), with the same protocol in
tokens per second; ``run_decode_benchmark`` (``:595``) times greedy
KV-cache decoding; ``run_compression_benchmark`` (``:793``) A/Bs a wire
codec on the LM's ZeRO lane.  ``run_hierarchical_benchmark`` (``:935``)
and its worker A/B the eager plane's two-level allreduce against the
flat one under the port's launcher.

``python -m horovod_tpu_torch.benchmark`` is the reference harness's CLI
(``_main``, ``:1427-1571``, with its flags and defaults): the synthetic
benchmark, ``--efficiency``, ``--step-guard``, ``--profile``, ``--lm``
(with ``--shard-optimizer``, ``--compression`` and the LM sizes),
``--hierarchical`` and ``--serving``; ``--model lm`` and ``--model
decode`` print the device-time breakdown of the LM step and of one
``generate`` call.  ``--device cpu`` asks for the CPU; without it every
rank runs on ``cuda:<local rank>`` and fails where there is no card.
The reference's ``--transport`` and ``--coordsim`` measure its native
transports and its protocol simulator, which the port does not have.
"""

from __future__ import annotations

import os
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from horovod_tpu_torch import basics, config, resilience
from horovod_tpu_torch.models import get_model
from horovod_tpu_torch.models.convert import (flax_ordered_parameters,
                                              lm_ordered_parameters)
from horovod_tpu_torch.models.resnet import space_to_depth
from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                  TransformerLM, generate)
from horovod_tpu_torch.models.transformer import (
    make_train_step as make_lm_train_step)
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.ops.fusion import fused_pytree_mean
from horovod_tpu_torch.optim import SGD
from horovod_tpu_torch.topology import (Mesh, build_mesh, data_axis,
                                        mesh_size)
from horovod_tpu_torch.utils.profiling import trace_steps

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
    # VGG-BN conv stacks (GAP head; the convs are >99% of FLOPs).
    "vgg11": 7.6, "vgg13": 11.3, "vgg16": 15.5, "vgg19": 19.6,
    # Inception V3: 5.7 GFLOPs at its canonical 299x299, ~3.2 at 224
    # under the quadratic spatial scaling applied below.
    "inception3": 3.2, "inceptionv3": 3.2,
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
                     remat: Optional[str] = None,
                     mesh: Optional[Mesh] = None,
                     learning_rate: float = 0.01, device=None,
                     seed: int = 0) -> BenchState:
    """The benchmark-state recipe: model, optimizer and this rank's shard
    of the fixed synthetic batch.  ``batch_size`` is per rank.  Runs on
    ``cuda:<local_rank>`` unless ``device`` (or an initialized CPU world)
    says otherwise; with no GPU and no device named it raises.  ``stem``
    and ``remat`` apply to the ResNets only, as in the reference.

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
    if remat and model_name.startswith("resnet"):
        extra["remat"] = remat
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
                            remat: Optional[str] = None,
                            device=None,
                            verbose: bool = True) -> dict:
    """Run the synthetic benchmark; returns a result dict.  ``batch_size``
    is per rank, as in the reference."""
    st = make_bench_state(model_name, batch_size, image_size=image_size,
                          num_classes=num_classes, input_dtype=input_dtype,
                          stem=stem, remat=remat, mesh=mesh,
                          learning_rate=learning_rate, device=device)
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


def run_scaling_efficiency(model_name: str = "resnet50",
                           batch_size: int = 64,
                           n_devices: Optional[int] = None,
                           verbose: bool = True,
                           **bench_kwargs) -> dict:
    """Weak-scaling efficiency (reference ``:644``): ``img_sec_n /
    (growth * img_sec_base)`` at a fixed per-rank batch, the reference's
    headline metric.

    The reference's baseline is the first device of every process; the
    port runs one process a card, so its baseline is one rank a host: the
    ranks with local rank 0 (``topology().leaders``) among the first
    ``n_devices``, on a mesh of their own while the others wait.  Growth
    is ``n / n_base``.  Every rank of the job calls it (it makes groups
    over the world) and gets rank 0's numbers."""
    if not basics.is_initialized():
        basics.init(device=bench_kwargs.get("device"))
    if basics.process_group() is not None:
        raise ValueError("scaling efficiency spans the whole world; a job "
                         "restricted by init(ranks=...) has none")
    world, rank = basics.size(), basics.rank()
    n = n_devices or world
    if n < 2:
        raise ValueError(f"scaling efficiency needs >= 2 devices, have {n}")
    base = [r for r in basics.topology().leaders if r < n]
    n_base = len(base)
    if n_base >= n:
        raise ValueError(
            f"scaling efficiency needs more total devices ({n}) than "
            f"baseline devices ({n_base}; one per process)")
    # Group creation is collective over the world: every rank makes both.
    base_group = dist.new_group(base)
    n_group = dist.new_group(list(range(n))) if n < world else None
    res_1 = res_n = None
    if rank in base:
        res_1 = run_synthetic_benchmark(model_name, batch_size,
                                        mesh=build_mesh(base_group),
                                        verbose=False, **bench_kwargs)
    dist.barrier()
    if rank < n:
        res_n = run_synthetic_benchmark(model_name, batch_size,
                                        mesh=build_mesh(n_group),
                                        verbose=False, **bench_kwargs)
    dist.barrier()
    nums = torch.tensor([res_1["img_sec_total"] if res_1 else 0.0,
                         res_n["img_sec_total"] if res_n else 0.0],
                        dtype=torch.float64, device=basics.device())
    dist.broadcast(nums, src=0)
    img_sec_1, img_sec_n = (float(v) for v in nums.cpu())
    growth = n / n_base
    efficiency = img_sec_n / (growth * img_sec_1)
    if verbose:
        print(f"{n_base} device(s): {img_sec_1:.1f} img/sec", flush=True)
        print(f"{n} devices: {img_sec_n:.1f} img/sec "
              f"(perfect: {growth * img_sec_1:.1f})", flush=True)
        print(f"Scaling efficiency: {efficiency * 100:.1f}%", flush=True)
    return {
        "model": model_name,
        "n_devices": n,
        "n_baseline_devices": n_base,
        "img_sec_1": img_sec_1,
        "img_sec_n": img_sec_n,
        "scaling_efficiency": efficiency,
    }


def run_step_guard_benchmark(model_name: str = "resnet50",
                             batch_size: int = 64,
                             verbose: bool = True,
                             **kwargs) -> dict:
    """The step guard's overhead (reference ``:745``): the synthetic
    benchmark with ``HOROVOD_STEP_GUARD`` unset, then with ``skip``, and
    the throughput delta.  ``make_train_step`` reads the policy once, so
    each run builds its own step; the environment is restored after.
    Target: < 2 % step time.  Prints one ``BENCH`` JSON line
    (``{"metric": "step_guard_overhead_pct", ...}``) and returns the same
    dict."""
    import json

    prev = os.environ.pop("HOROVOD_STEP_GUARD", None)
    try:
        base = run_synthetic_benchmark(model_name, batch_size,
                                       verbose=False, **kwargs)
        os.environ["HOROVOD_STEP_GUARD"] = "skip"
        guarded = run_synthetic_benchmark(model_name, batch_size,
                                          verbose=False, **kwargs)
    finally:
        if prev is None:
            os.environ.pop("HOROVOD_STEP_GUARD", None)
        else:
            os.environ["HOROVOD_STEP_GUARD"] = prev
    overhead_pct = ((base["img_sec_total"] - guarded["img_sec_total"])
                    / base["img_sec_total"] * 100.0)
    result = {
        "metric": "step_guard_overhead_pct",
        "value": round(overhead_pct, 3),
        "unit": "%",
        "target_pct": 2.0,
        "model": model_name,
        "baseline_img_sec": round(base["img_sec_total"], 1),
        "guarded_img_sec": round(guarded["img_sec_total"], 1),
    }
    if verbose:
        print(f"Step guard overhead: {overhead_pct:.2f}% "
              f"({base['img_sec_total']:.1f} -> "
              f"{guarded['img_sec_total']:.1f} img/sec; target < 2%)",
              flush=True)
    print("BENCH " + json.dumps(result), flush=True)
    return result


def lm_train_flops(cfg, global_bs: int) -> float:
    """Analytic GLOBAL FLOPs of one LM training step (reference ``:428``):
    ``6 * N * tokens`` for every matmul parameter (embedding lookup
    excluded, tied logits head included) plus causal attention
    ``6 * B * T^2 * d * L``."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    l, t = cfg.n_layers, cfg.max_seq
    n_matmul = l * (4 * d * d + 2 * d * f) + d * v
    tokens = global_bs * t
    return 6.0 * n_matmul * tokens + 6.0 * global_bs * t * t * d * l


class LMBenchState(NamedTuple):
    mesh: Mesh
    axis: Optional[dist.ProcessGroup]
    cfg: TransformerConfig
    model: TransformerLM
    optimizer: SGD
    tokens: torch.Tensor       # this rank's shard, int64 [B, T]
    labels: torch.Tensor


def make_lm_bench_state(d_model: int = 2048, n_layers: int = 8,
                        n_heads: int = 16, d_ff: Optional[int] = None,
                        vocab_size: int = 32768, seq_len: int = 2048,
                        batch_size: int = 8, learning_rate: float = 1e-4,
                        momentum_dtype: str = "bfloat16",
                        mesh: Optional[Mesh] = None, device=None,
                        seed: int = 0,
                        compute_dtype: Optional[str] = None) -> LMBenchState:
    """The LM benchmark's state recipe (reference ``run_lm_benchmark``):
    bf16 compute on the GPU and f32 on the CPU (or ``compute_dtype``,
    ``"bfloat16"`` or ``"float32"``), f32 parameters from
    ``torch.Generator(device).manual_seed(seed)``, SGD with momentum 0.9
    and a ``momentum_dtype`` accumulator, and this rank's rows of the
    fixed synthetic batch (numpy ``default_rng(0)`` tokens ``[B, T+1]``,
    shifted by one for the labels).  ``batch_size`` is per rank."""
    for name, value in (("momentum_dtype", momentum_dtype),
                        ("compute_dtype", compute_dtype)):
        if value is not None and value not in _DTYPES:
            raise ValueError(f"{name}={value!r}: expected one of "
                             f"{sorted(_DTYPES)}")
    if not basics.is_initialized():
        basics.init(device=device)
    mesh = mesh if mesh is not None else basics.mesh()
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device={device!r} but the mesh runs on "
                         f"{mesh.device}")
    group = data_axis(mesh)
    n, rank = mesh_size(mesh), dist.get_rank(group)
    dev = mesh.device
    cfg = TransformerConfig(
        vocab_size=vocab_size, d_model=d_model, n_heads=n_heads,
        n_layers=n_layers, d_ff=d_ff or 4 * d_model, max_seq=seq_len,
        dtype=(_DTYPES[compute_dtype] if compute_dtype is not None
               else torch.float32 if dev.type == "cpu" else torch.bfloat16))
    model = TransformerLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev)
    acc = _DTYPES[momentum_dtype]
    optimizer = SGD([p for _, p in lm_ordered_parameters(model)],
                    learning_rate, momentum=0.9,
                    accumulator_dtype=None if acc == torch.float32 else acc)
    toks = np.random.default_rng(0).integers(
        0, vocab_size, (batch_size * n, seq_len + 1), dtype=np.int32)
    rows = toks[rank * batch_size:(rank + 1) * batch_size].astype(np.int64)
    tokens = torch.from_numpy(rows[:, :-1].copy()).to(dev)
    labels = torch.from_numpy(rows[:, 1:].copy()).to(dev)
    return LMBenchState(mesh, group, cfg, model, optimizer, tokens, labels)


def run_lm_benchmark(d_model: int = 2048, n_layers: int = 8,
                     n_heads: int = 16, d_ff: Optional[int] = None,
                     vocab_size: int = 32768, seq_len: int = 2048,
                     batch_size: int = 8, attention: str = "flash",
                     remat: str = "none", num_warmup_batches: int = 2,
                     num_batches_per_iter: int = 8, num_iters: int = 5,
                     learning_rate: float = 1e-4,
                     mesh: Optional[Mesh] = None,
                     shard_optimizer: bool = False,
                     compression: Optional[str] = None,
                     momentum_dtype: str = "bfloat16", device=None,
                     verbose: bool = True) -> dict:
    """Transformer-LM synthetic training benchmark (reference ``:443``):
    warmup steps, then ``num_iters`` rounds of ``num_batches_per_iter``
    steps, tok/s as mean +- 1.96 sigma over rounds (CUDA events on the
    GPU), ms/step, MFU from the analytic :func:`lm_train_flops` against
    the card's peak, and peak device memory.  ``batch_size`` is per rank.

    ``shard_optimizer=True`` runs the ZeRO-1 sharded update over the
    mesh's data group (the whole world unless ``mesh`` says otherwise)
    and ``compression`` its wire codec (``"none"``, ``"bf16"``,
    ``"fp16"``, ``"int8"``, ``"powersgd[:rank]"``).  The result also
    reports this rank's optimizer-state bytes (the momentum, and the
    codec's residuals and factors) and the logical wire bytes a step
    puts on the wire (``fusion.collective_bytes`` over the timed steps).
    """
    st = make_lm_bench_state(d_model, n_layers, n_heads, d_ff, vocab_size,
                             seq_len, batch_size, learning_rate,
                             momentum_dtype, mesh, device)
    dev, cfg = st.mesh.device, st.cfg
    n_chips = mesh_size(st.mesh)
    global_bs = batch_size * n_chips
    step = make_lm_train_step(
        st.model, st.optimizer, st.mesh, st.axis, attention=attention,
        remat=remat, shard_optimizer=shard_optimizer,
        compression=compression)
    if shard_optimizer:
        step.init()
    flops_per_step = lm_train_flops(cfg, global_bs)
    if verbose:
        comp_s = f" compression={compression}" if compression else ""
        print(f"LM: d_model={d_model} n_layers={n_layers} d_ff={cfg.d_ff} "
              f"vocab={vocab_size} T={seq_len} batch={global_bs} "
              f"attention={attention} remat={remat} "
              f"momentum={momentum_dtype} shard_optimizer={shard_optimizer}"
              f"{comp_s} ranks={n_chips} on {dev}", flush=True)
        print(f"Analytic {flops_per_step / 1e12:.2f} TFLOP/step "
              f"({flops_per_step / (global_bs * seq_len) / 1e6:.1f} "
              f"MFLOP/token)", flush=True)

    for _ in range(num_warmup_batches):
        step(st.tokens, st.labels)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    rounds = _Rounds(dev)
    losses = []
    wire0 = fusion.collective_bytes.total()
    rounds.mark()
    for _ in range(num_iters):
        for _ in range(num_batches_per_iter):
            losses.append(step(st.tokens, st.labels))
        rounds.mark()
    secs = rounds.seconds()
    timed_steps = num_iters * num_batches_per_iter
    wire_per_step = ((fusion.collective_bytes.total() - wire0)
                     / max(timed_steps, 1))
    state_bytes = (step.sharded.state.nbytes() if shard_optimizer else sum(
        t.numel() * t.element_size() for t in st.optimizer.trace))
    step_losses = [float(x) for x in losses]
    tokens_per_round = global_bs * seq_len * num_batches_per_iter
    tok_secs = [tokens_per_round / dt for dt in secs]
    tok_sec_mean = float(np.mean(tok_secs))
    ms_per_step = float(np.mean(secs)) / num_batches_per_iter * 1e3
    tflops_per_chip = (flops_per_step * tok_sec_mean / (global_bs * seq_len)
                       / n_chips / 1e12)
    peak = device_peak_tflops(dev)
    on_gpu = dev.type == "cuda"
    result = {
        "d_model": d_model, "n_layers": n_layers, "d_ff": cfg.d_ff,
        "n_heads": n_heads, "vocab_size": vocab_size, "seq_len": seq_len,
        "batch_size": global_bs, "attention": attention, "remat": remat,
        "momentum_dtype": momentum_dtype, "n_chips": n_chips,
        "platform": "gpu" if on_gpu else "cpu",
        "device": torch.cuda.get_device_name(dev) if on_gpu else "cpu",
        "tok_sec_per_chip": tok_sec_mean / n_chips,
        "tok_sec_conf": float(1.96 * np.std(tok_secs)) / n_chips,
        "ms_per_step": ms_per_step,
        "flops_per_step_analytic": flops_per_step,
        "tflops_per_chip": tflops_per_chip if on_gpu else None,
        "peak_tflops": peak,
        "mfu": tflops_per_chip / peak if peak else None,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if on_gpu else None),
        "shard_optimizer": shard_optimizer,
        "compression": (step.optimizer.codec.name if shard_optimizer
                        else "none"),
        "optimizer_state_bytes": state_bytes,
        "wire_bytes_per_step": wire_per_step,
        "step_losses": step_losses,
        "loss": step_losses[-1] if step_losses else None,
    }
    if verbose:
        for i, v in enumerate(tok_secs):
            print(f"Iter #{i}: {v:,.0f} tok/sec", flush=True)
        mfu = result["mfu"]
        mfu_s = f", MFU {mfu * 100:.2f}%" if mfu is not None else ""
        print(f"{result['tok_sec_per_chip']:,.0f} tok/sec/chip "
              f"+-{result['tok_sec_conf']:,.0f} ({ms_per_step:.2f} "
              f"ms/step){mfu_s}", flush=True)
    return result


def run_compression_benchmark(codec: str = "int8", verbose: bool = True,
                              **lm_kwargs) -> dict:
    """Gradient-compression A/B on the LM's ZeRO lane (reference
    ``:793``): :func:`run_lm_benchmark` twice from the same seeds, with
    the uncompressed wire and with ``codec``, and the loss at equal steps
    beside the ratio of the logical wire bytes of the reduce-scatter and
    all-gather (``fusion.collective_bytes``, counted per run).  Prints one
    ``BENCH`` JSON line (``{"metric": "compression_wire_ratio", ...}``)
    and returns the same dict."""
    import json

    from horovod_tpu_torch.ops import compression as compression_mod

    name = compression_mod.resolve_codec(codec).name
    if name == "none":
        raise ValueError(
            "--compression needs a real codec (bf16, fp16, int8, "
            "powersgd[:rank]); the lane already compares against 'none'")
    # The codec rides the ZeRO reduce-scatter wire.
    lm_kwargs["shard_optimizer"] = True

    def run(spec, label):
        before = {k: fusion.collective_bytes.total(kind=k, codec=label)
                  for k in ("reduce_scatter", "all_gather")}
        res = run_lm_benchmark(compression=spec, verbose=verbose,
                               **lm_kwargs)
        return res, sum(fusion.collective_bytes.total(kind=k, codec=label)
                        - b for k, b in before.items())

    base, bytes_none = run("none", "none")
    comp, bytes_codec = run(codec, name)
    ratio = (bytes_none / bytes_codec) if bytes_codec else float("inf")
    loss_delta_pct = (abs(comp["loss"] - base["loss"])
                      / max(abs(base["loss"]), 1e-12) * 100.0)
    # Acceptance floors: int8 packs 4 f32 bytes into about 1 wire byte
    # (less the per-bucket qparams), the casts halve them.
    target = {"int8": 3.0, "bf16": 1.9, "fp16": 1.9}.get(name)
    result = {
        "metric": "compression_wire_ratio",
        "codec": name,
        "value": round(ratio, 3),
        "target_ratio": target,
        "wire_bytes_none": int(bytes_none),
        "wire_bytes_codec": int(bytes_codec),
        "loss_none": round(base["loss"], 6),
        "loss_codec": round(comp["loss"], 6),
        "loss_delta_pct": round(loss_delta_pct, 4),
        "loss_target_pct": 1.0,
        "n_chips": base["n_chips"],
        "d_model": base["d_model"],
        "n_layers": base["n_layers"],
        "tok_sec_per_chip_none": round(base["tok_sec_per_chip"], 1),
        "tok_sec_per_chip_codec": round(comp["tok_sec_per_chip"], 1),
    }
    if verbose:
        tgt = f" (target >= {target}x)" if target else ""
        print(f"Compression {name}: wire bytes {int(bytes_none):,} -> "
              f"{int(bytes_codec):,} ({ratio:.2f}x{tgt}); loss "
              f"{base['loss']:.5f} -> {comp['loss']:.5f} "
              f"({loss_delta_pct:.3f}% delta, target < 1%)", flush=True)
    print("BENCH " + json.dumps(result), flush=True)
    return result


class DecodeBenchState(NamedTuple):
    cfg: TransformerConfig
    params: dict            # the model's tree, f32 leaves
    prompt: torch.Tensor    # int64 [B, prompt_len]


def make_decode_bench_state(d_model: int = 2048, n_layers: int = 8,
                            n_heads: int = 16, vocab_size: int = 32768,
                            batch_size: int = 8, prompt_len: int = 16,
                            total_len: int = 512, device=None,
                            seed: int = 0) -> DecodeBenchState:
    """The decode benchmark's state recipe (reference
    ``run_decode_benchmark``): bf16 compute on the GPU and f32 on the
    CPU, ``d_ff = 4 * d_model``, a cache of ``total_len`` positions, f32
    parameters from ``torch.Generator(device).manual_seed(seed)`` and a
    numpy ``default_rng(0)`` prompt ``[B, prompt_len]``."""
    if prompt_len >= total_len:
        raise ValueError(f"prompt_len ({prompt_len}) must be < "
                         f"total_len ({total_len}) to decode anything")
    dev = basics.resolve_device(device)
    cfg = TransformerConfig(
        vocab_size=vocab_size, d_model=d_model, n_heads=n_heads,
        n_layers=n_layers, d_ff=4 * d_model, max_seq=total_len,
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)
    model = TransformerLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, vocab_size, (batch_size, prompt_len))).to(dev)
    return DecodeBenchState(cfg, model.tree(), prompt)


def run_decode_benchmark(d_model: int = 2048, n_layers: int = 8,
                         n_heads: int = 16, vocab_size: int = 32768,
                         batch_size: int = 8, prompt_len: int = 16,
                         total_len: int = 512, num_iters: int = 3,
                         device=None, seed: int = 0,
                         verbose: bool = True) -> dict:
    """Greedy-decode (KV-cache) throughput (reference ``:595``): new
    tokens/s and ms per decode step of :func:`~horovod_tpu_torch.models.
    transformer.generate` on :func:`make_decode_bench_state`'s model and
    prompt.  One warmup call, then ``num_iters`` timed calls (CUDA events
    on the GPU); ``decode_tok_sec`` counts the ``B * (total_len -
    prompt_len)`` new tokens, ``ms_per_step`` divides a call by its
    ``total_len - 1`` decode steps (the prompt's positions are stepped
    too)."""
    st = make_decode_bench_state(d_model, n_layers, n_heads, vocab_size,
                                 batch_size, prompt_len, total_len, device,
                                 seed)
    cfg, params, prompt = st.cfg, st.params, st.prompt
    dev = prompt.device
    on_gpu = dev.type == "cuda"
    generate(params, prompt, total_len, cfg)
    if on_gpu:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    rounds = _Rounds(dev)
    rounds.mark()
    for _ in range(num_iters):
        generate(params, prompt, total_len, cfg)
        rounds.mark()
    dt = float(np.mean(rounds.seconds()))
    res = {
        "d_model": d_model, "n_layers": n_layers,
        "batch_size": batch_size, "total_len": total_len,
        "decode_tok_sec": batch_size * (total_len - prompt_len) / dt,
        "ms_per_step": dt / (total_len - 1) * 1e3,
        "platform": "gpu" if on_gpu else "cpu",
        "device": torch.cuda.get_device_name(dev) if on_gpu else "cpu",
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if on_gpu else None),
    }
    if verbose:
        print(f"decode d{d_model} L{n_layers} B{batch_size}: "
              f"{res['decode_tok_sec']:,.0f} tok/s, "
              f"{res['ms_per_step']:.2f} ms/step", flush=True)
    return res


def run_serving_benchmark(out: Optional[str] = None, *,
                          num_requests: int = 64,
                          tokens_per_request: int = 8,
                          step_time: float = 0.002, device=None,
                          verbose: bool = False) -> dict:
    """Offered load against latency for the continuous-batching router
    (reference ``:1270``), A/B-ing two batch policies: one sequence a
    replica step (``max_batch=1``) against ``max_batch=8``.

    The rig runs on a virtual clock: two in-process replicas whose
    :class:`~horovod_tpu_torch.serving.ToyModel` lives on ``device``, no
    real sleep, time advanced by a fixed modelled step cost.  So the
    lane is deterministic and its tokens/s and latencies are properties
    of the batching policy under that cost, not of the card."""
    import json

    from horovod_tpu_torch.serving import (LocalReplicaHandle,
                                           ReplicaWorker, Router,
                                           TenantConfig, ToyModel)

    dev = basics.resolve_device(device)
    rows = []
    for policy in (1, 8):
        for offered_rps in (50.0, 200.0, 800.0):
            vt = [0.0]  # virtual seconds; advanced per decode step
            replicas = [
                LocalReplicaHandle(ReplicaWorker(ToyModel(device=dev),
                                                 replica_id=f"r{i}"))
                for i in range(2)]
            router = Router(replicas,
                            [TenantConfig("bench", quota=1 << 30,
                                          slo_ms=0.0)],
                            max_batch=policy, clock=lambda: vt[0])
            arrivals = [i / offered_rps for i in range(num_requests)]
            pending = {}
            lats = []
            done = 0
            nxt = 0
            while done < num_requests:
                while nxt < num_requests and arrivals[nxt] <= vt[0]:
                    h = router.submit("bench", prompt_token=nxt,
                                      max_new_tokens=tokens_per_request)
                    assert h.rejected is None, h.rejected
                    pending[h.request_id] = (h, arrivals[nxt])
                    nxt += 1
                router.step()
                vt[0] += step_time
                for rid, (h, t0) in list(pending.items()):
                    if h.completed:
                        lats.append(vt[0] - t0)
                        done += 1
                        del pending[rid]
            router.close()
            lats.sort()
            rows.append({
                "policy_max_batch": policy,
                "offered_rps": offered_rps,
                "p50_ms": round(lats[len(lats) // 2] * 1e3, 3),
                "p99_ms": round(
                    lats[min(len(lats) - 1,
                             int(0.99 * len(lats)))] * 1e3, 3),
                "tokens_per_s": round(
                    num_requests * tokens_per_request / vt[0], 1),
            })
            if verbose:
                r = rows[-1]
                print(f"serving max_batch={policy} "
                      f"{offered_rps:g} req/s: p50 {r['p50_ms']} ms, "
                      f"p99 {r['p99_ms']} ms, "
                      f"{r['tokens_per_s']} tok/s", flush=True)
    result = {
        "metric": "serving_continuous_batching",
        "replicas": 2,
        "num_requests": num_requests,
        "tokens_per_request": tokens_per_request,
        "step_time_ms": step_time * 1e3,
        "rows": rows,
        "device": str(dev),
        "note": "virtual-clock rig: two in-process replicas with a "
                "fixed modeled decode-step cost; numbers compare "
                "batching policies, not hardware",
    }
    print("BENCH " + json.dumps(result), flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")
    return result


def run_profile(model_name: str = "resnet50", batch_size: int = 64,
                image_size: int = 224, steps: int = 5,
                input_dtype: str = "bfloat16", stem: str = "s2d_fused",
                remat: Optional[str] = None, device=None,
                top: int = 15, layers: bool = False) -> dict:
    """Trace ``steps`` training steps of a registered model (see
    :func:`~horovod_tpu_torch.utils.profiling.trace_steps`; ``layers``
    adds the top layers).  Same state recipe as the throughput run, so
    the trace explains the program the benchmark measures.  Needs a CUDA
    device."""
    st = make_bench_state(model_name, batch_size, image_size=image_size,
                          input_dtype=input_dtype, stem=stem, remat=remat,
                          device=device)
    step = make_train_step(st.model, st.optimizer, st.mesh, st.axis)
    out = {"model": model_name, "stem": stem if st.s2d else "conv7",
           "remat": remat, "batch_size": batch_size}
    out.update(trace_steps(lambda: step(st.images, st.labels),
                           st.mesh.device, steps, top, layers=layers))
    return out


# The LM benchmark of record (``bench.py:133-144``): the profile's model.
LM_OF_RECORD = dict(d_model=3072, n_layers=10, n_heads=24, d_ff=12288,
                    vocab_size=32768, seq_len=2048)


def run_lm_profile(batch_size: int = 4, steps: int = 5, device=None,
                   top: int = 15, shard_optimizer: bool = False,
                   compression: Optional[str] = None,
                   dtype: str = "bfloat16") -> dict:
    """Trace ``steps`` flash-attention training steps of the LM benchmark
    of record (:data:`LM_OF_RECORD`, :func:`run_lm_benchmark`'s recipe,
    the ZeRO-1 update and its codec as there); the flash kernels are
    their own category.  ``dtype="float32"`` computes in f32 with an f32
    momentum, as ``chip_smoke.py``'s f32 LM of record does (its matrix
    products in f32 unless ``torch.backends.cuda.matmul.allow_tf32``,
    reported, is set).  Needs a CUDA device."""
    st = make_lm_bench_state(**LM_OF_RECORD, batch_size=batch_size,
                             device=device, compute_dtype=dtype,
                             momentum_dtype=dtype)
    step = make_lm_train_step(st.model, st.optimizer, st.mesh, st.axis,
                              attention="flash",
                              shard_optimizer=shard_optimizer,
                              compression=compression)
    out = {"model": "lm", **LM_OF_RECORD, "batch_size": batch_size,
           "dtype": dtype, "attention": "flash",
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "shard_optimizer": shard_optimizer, "compression": compression}
    out.update(trace_steps(lambda: step(st.tokens, st.labels),
                           st.mesh.device, steps, top))
    return out


def run_decode_profile(batch_size: int = 8) -> dict:
    """Trace one ``generate`` call of :func:`run_decode_benchmark` at its
    defaults (d2048/L8/H16, vocab 32768, prompt 16, total 512, bf16;
    :func:`make_decode_bench_state`), and give its numbers per decode
    step too (a call steps ``total_len - 1`` times): how much of a step
    the device is busy shows how much of it the host's launches take.
    Needs a CUDA device."""
    st = make_decode_bench_state(batch_size=batch_size)
    total_len = st.cfg.max_seq
    out = {"model": "decode", "batch_size": batch_size,
           "prompt_len": st.prompt.shape[1], "total_len": total_len}
    out.update(trace_steps(
        lambda: generate(st.params, st.prompt, total_len, st.cfg),
        st.prompt.device, 1, 15))
    steps = total_len - 1
    out["per_decode_step"] = {
        "wall_ms": out["wall_ms_per_step"] / steps,
        "kernel_ms": out["kernel_ms_per_step"] / steps,
        "kernels": out["kernels_per_step"] / steps}
    return out


def run_hierarchical_worker(sizes=(1 << 16, 1 << 20), iters: int = 8,
                            device=None) -> None:
    """Worker half of ``--hierarchical`` (reference ``:880``), spawned by
    :func:`run_hierarchical_benchmark` under the port's launcher: it
    splits the ranks into hosts of ``size // 2`` (``HOROVOD_LOCAL_*``
    set before ``init``, the trick of
    ``tests/distributed/hier_check_np4.py``), checks that
    ``tuned_config()`` and ``sync_tuned_config()`` route the way the
    A/B run asked, then times eager allreduces of each payload size and
    sums the bytes each path put on the cross level over the ranks.  On
    the card each rank keeps the card of its launcher-given local rank.
    Rank 0 prints one ``HIERBENCH {json}`` line per size."""
    import json

    from horovod_tpu_torch.ops import collective

    rank = int(os.environ["HOROVOD_RANK"])
    size = int(os.environ["HOROVOD_SIZE"])
    if device is None:
        device = basics.resolve_device(
            None, int(os.environ.get("HOROVOD_LOCAL_RANK", "0")))
    local = max(size // 2, 1)
    os.environ["HOROVOD_LOCAL_SIZE"] = str(local)
    os.environ["HOROVOD_LOCAL_RANK"] = str(rank % local)
    basics.init(device=device)
    rt = basics.runtime()
    hier = config.env_bool("HOROVOD_HIERARCHICAL_ALLREDUCE")
    cfg = rt.tuned_config()
    if cfg["hier_allreduce"] is not hier:
        raise RuntimeError(f"tuned_config() does not reflect the requested "
                           f"routing: {cfg}")
    dev = basics.device()
    rows = []
    for n in sizes:
        x = torch.from_numpy(np.random.default_rng(rank).standard_normal(
            n).astype(np.float32)).to(dev)
        for i in range(2):
            collective.allreduce(x, op=collective.Sum, name=f"hb.warm{i}.{n}")
        before = dict(rt.hier_counters)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for i in range(iters):
            collective.allreduce(x, op=collective.Sum, name=f"hb.{i}.{n}")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) / iters
        key = "hier_cross_bytes" if hier else "flat_allreduce_bytes"
        moved = torch.tensor([float(rt.hier_counters[key] - before[key])],
                             device=dev)
        total = collective.allreduce(moved, op=collective.Sum,
                                     name=f"hb.bytes.{n}")
        rows.append({"size": n, "sec_per_op": dt,
                     "mb_per_sec": n * 4 / dt / 2**20,
                     "cross_bytes" if hier else "flat_bytes":
                         int(total.item())})
    agreed = rt.sync_tuned_config()
    if agreed["hier_allreduce"] is not hier:
        raise RuntimeError(f"sync_tuned_config() does not reflect the "
                           f"requested routing: {agreed}")
    basics.shutdown()
    if rank == 0:
        for r in rows:
            print("HIERBENCH " + json.dumps(r), flush=True)


def run_hierarchical_benchmark(np_ranks: int = 4,
                               out: Optional[str] = None,
                               verbose: bool = True,
                               device: Optional[str] = None,
                               timeout: float = 600.0) -> dict:
    """The two-level eager allreduce against the flat one (reference
    ``:935``): two ``python -m horovod_tpu_torch.runner -np 4`` runs of
    :func:`run_hierarchical_worker`, flat and with
    ``HOROVOD_HIERARCHICAL_ALLREDUCE=1`` at threshold 0, and each size's
    latency side by side with the bytes each path put across hosts
    (summed over the ranks; the two-level path's are the flat path's
    over ``local_size``).  ``device="cpu"`` runs the ranks on gloo (one
    intra-op thread each); by default each rank takes a card.  Prints one
    ``BENCH`` JSON line and (with ``out``) writes the same dict there."""
    import json
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def launch(hier: bool) -> list:
        env = dict(os.environ)
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        env["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1" if hier else "0"
        env["HOROVOD_HIERARCHICAL_ALLREDUCE_THRESHOLD"] = "0"
        worker = [sys.executable, "-m", "horovod_tpu_torch.benchmark",
                  "--hierarchical"]
        if device is not None:
            worker += ["--device", device]
            if torch.device(device).type == "cpu":
                env["OMP_NUM_THREADS"] = "1"
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner",
               "-np", str(np_ranks), *worker]
        p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=timeout)
        if p.returncode != 0:
            raise RuntimeError(
                f"hierarchical bench run (hier={hier}) failed rc="
                f"{p.returncode}\n{p.stdout[-2000:]}\n{p.stderr[-2000:]}")
        rows = [json.loads(line.split("HIERBENCH ", 1)[1])
                for line in p.stdout.splitlines() if "HIERBENCH " in line]
        if not rows:
            raise RuntimeError(
                f"hierarchical bench run (hier={hier}) printed no "
                f"HIERBENCH rows:\n{p.stdout[-2000:]}")
        return rows

    flat = {r["size"]: r for r in launch(False)}
    hier = {r["size"]: r for r in launch(True)}
    local_size = max(np_ranks // 2, 1)
    sizes = []
    for n in sorted(flat):
        sizes.append({
            "size": n,
            "flat_sec_per_op": flat[n]["sec_per_op"],
            "hier_sec_per_op": hier[n]["sec_per_op"],
            "speedup": flat[n]["sec_per_op"] / hier[n]["sec_per_op"],
            "flat_bytes": flat[n]["flat_bytes"],
            "cross_bytes": hier[n]["cross_bytes"],
        })
    result = {
        "metric": "hierarchical_allreduce_latency",
        "np": np_ranks,
        "local_size": local_size,
        "device": device or "cuda",
        "knob_observed_live": True,   # every worker asserted it
        "cross_bytes_ratio": [s["cross_bytes"] / s["flat_bytes"]
                              for s in sizes],
        "sizes": sizes,
    }
    if verbose:
        for s in sizes:
            print(f"allreduce {s['size']:>8} floats: flat "
                  f"{s['flat_sec_per_op'] * 1e3:.3f} ms, hier "
                  f"{s['hier_sec_per_op'] * 1e3:.3f} ms "
                  f"({s['speedup']:.2f}x), cross bytes "
                  f"{s['cross_bytes']} of flat {s['flat_bytes']}",
                  flush=True)
    print("BENCH " + json.dumps(result), flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")
    return result


def build_parser():
    """The reference harness's flags (``horovod_tpu/benchmark.py:1427-
    1535``) with its defaults, less ``--transport`` and ``--coordsim``,
    plus ``--device``, the profiles' ``--model lm|decode`` and the LM
    profile's ``--lm-dtype``."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Synthetic benchmark (reference "
                    "examples/tensorflow2_synthetic_benchmark.py)")
    parser.add_argument("--model", default="resnet50",
                        help="a registered model, or 'lm' / 'decode' for "
                             "the device-time breakdown of the LM step / "
                             "of one generate call")
    parser.add_argument("--batch-size", type=int, default=64,
                        help="per-rank batch size")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--num-warmup-batches", type=int, default=5)
    parser.add_argument("--num-batches-per-iter", type=int, default=10)
    parser.add_argument("--num-iters", type=int, default=10)
    parser.add_argument("--efficiency", action="store_true",
                        help="weak-scaling efficiency: 1 device vs all")
    parser.add_argument("--profile", action="store_true",
                        help="trace one round and print the per-op/"
                             "per-layer device-time breakdown")
    parser.add_argument("--stem", default="conv7",
                        choices=("conv7", "s2d", "s2d_fused"))
    parser.add_argument("--input-dtype", default="float32",
                        choices=sorted(_DTYPES))
    parser.add_argument("--lm-dtype", default="bfloat16",
                        choices=sorted(_DTYPES),
                        help="the compute dtype of --model lm's profile")
    parser.add_argument("--device", default=None,
                        help="'cpu' runs on the CPU over gloo (default: "
                             "cuda:<local rank>)")
    parser.add_argument("--lm", action="store_true",
                        help="run the transformer-LM lane instead of the "
                             "ResNet harness")
    parser.add_argument("--step-guard", action="store_true",
                        help="measure the NaN/Inf step-guard overhead: "
                             "baseline vs HOROVOD_STEP_GUARD=skip "
                             "(target < 2%% step time)")
    parser.add_argument("--shard-optimizer", action="store_true",
                        help="LM lane with the ZeRO-1 sharded update over "
                             "all ranks (reports MFU and memory)")
    parser.add_argument("--compression", default=None, metavar="CODEC",
                        help="A/B the LM ZeRO lane with gradient codec "
                             "CODEC (bf16, fp16, int8, powersgd[:rank]) "
                             "against the uncompressed wire; prints a "
                             "BENCH JSON row with the wire-byte ratio "
                             "and loss delta")
    parser.add_argument("--hierarchical", action="store_true",
                        help="A/B the 2-level eager allreduce vs the "
                             "flat ring over two -np 4 runs of the "
                             "port's launcher; prints a BENCH JSON row "
                             "(inside a launched rank this flag selects "
                             "the worker half instead)")
    parser.add_argument("--serving", action="store_true",
                        help="offered load vs p50/p99 latency and "
                             "tokens/s for the continuous-batching "
                             "router at max_batch 1 vs 8")
    parser.add_argument("--out", default=None, metavar="FILE",
                        help="also write the BENCH result dict to FILE")
    parser.add_argument("--d-model", type=int, default=None)
    parser.add_argument("--n-layers", type=int, default=None)
    parser.add_argument("--seq-len", type=int, default=None)
    parser.add_argument("--vocab-size", type=int, default=None)
    return parser


def _main(argv=None) -> None:
    import json

    args = build_parser().parse_args(argv)
    kwargs = dict(image_size=args.image_size,
                  num_warmup_batches=args.num_warmup_batches,
                  num_batches_per_iter=args.num_batches_per_iter,
                  num_iters=args.num_iters)
    if args.serving:
        run_serving_benchmark(out=args.out, verbose=True, device=args.device)
        return
    if args.hierarchical:
        if "HOROVOD_RANK" in os.environ:
            run_hierarchical_worker(device=args.device)
        else:
            run_hierarchical_benchmark(out=args.out, device=args.device)
        return
    basics.init(device=args.device)
    on_cpu = basics.device().type == "cpu"
    if args.lm or args.shard_optimizer or args.compression:
        lm_kwargs = dict(num_warmup_batches=args.num_warmup_batches,
                         num_batches_per_iter=args.num_batches_per_iter,
                         num_iters=args.num_iters,
                         shard_optimizer=args.shard_optimizer)
        if on_cpu:
            # A CPU run checks the plumbing: a config the CPU finishes in
            # seconds, local attention (the flash kernels need the card).
            lm_kwargs.update(d_model=128, n_layers=2, n_heads=4,
                             d_ff=256, vocab_size=512, seq_len=64,
                             batch_size=2, attention="local",
                             num_batches_per_iter=min(
                                 args.num_batches_per_iter, 2),
                             num_iters=min(args.num_iters, 3))
        for k, v in (("d_model", args.d_model),
                     ("n_layers", args.n_layers),
                     ("seq_len", args.seq_len),
                     ("vocab_size", args.vocab_size)):
            if v is not None:
                lm_kwargs[k] = v
        # --batch-size is the ResNet knob (default 64); the LM lane keeps
        # its own default of 8 a rank unless the flag was set.
        bs = lm_kwargs.pop("batch_size",
                           args.batch_size if args.batch_size != 64 else 8)
        if args.compression:
            run_compression_benchmark(args.compression, batch_size=bs,
                                      **lm_kwargs)
        else:
            res = run_lm_benchmark(batch_size=bs, **lm_kwargs)
            res.pop("step_losses")
            print(json.dumps(res, indent=1), flush=True)
    elif args.model == "lm":
        print(json.dumps(run_lm_profile(
            batch_size=args.batch_size if args.batch_size != 64 else 4,
            dtype=args.lm_dtype), indent=1), flush=True)
    elif args.model == "decode":
        print(json.dumps(run_decode_profile(
            batch_size=args.batch_size if args.batch_size != 64 else 8),
            indent=1), flush=True)
    elif args.step_guard:
        sg_kwargs = dict(kwargs, stem=args.stem,
                         input_dtype=args.input_dtype)
        model, bs = args.model, args.batch_size
        if on_cpu:
            # The lane runs the step twice (baseline and guarded): a size
            # the CPU finishes in seconds.
            model = "resnet18" if args.model == "resnet50" else args.model
            bs = min(bs, 4)
            sg_kwargs.update(image_size=min(args.image_size, 64),
                             num_warmup_batches=1,
                             num_batches_per_iter=min(
                                 args.num_batches_per_iter, 2),
                             num_iters=min(args.num_iters, 3))
        run_step_guard_benchmark(model, bs, **sg_kwargs)
    elif args.profile:
        print(json.dumps(run_profile(
            args.model, args.batch_size, args.image_size,
            steps=args.num_batches_per_iter, input_dtype=args.input_dtype,
            stem=args.stem), indent=1), flush=True)
    elif args.efficiency:
        run_scaling_efficiency(args.model, args.batch_size, stem=args.stem,
                               input_dtype=args.input_dtype, **kwargs)
    else:
        res = run_synthetic_benchmark(args.model, args.batch_size,
                                      stem=args.stem,
                                      input_dtype=args.input_dtype,
                                      **kwargs)
        print("RESULT " + json.dumps(
            {k: v for k, v in res.items() if k != "step_losses"}),
            flush=True)
    basics.shutdown()


if __name__ == "__main__":
    _main()
