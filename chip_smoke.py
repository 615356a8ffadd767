#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (``/usr/local/cuda``).  Phases, in order;
any failure ends the run with a traceback and a non-zero exit:

1. card: the GPU's name and power limit as nvidia-smi reports them;
2. build: every kernel under ``horovod_tpu_torch/ops/csrc`` with nvcc;
3. kernel check: each kernel against its plain PyTorch version on the
   card (bitwise), gradients through its autograd Function, and its time
   beside the plain version's and the least time the card could take;
4. main path: ``hvd.init()`` (an NCCL group of size 1) and the ResNet-50
   ``s2d_fused`` synthetic training benchmark at 224x224, full width,
   bf16, with the kernel and collective counts read around it;
5. reference: a small ResNet's train step on the GPU against the same step
   on the CPU (the CPU port is held against the JAX package by the tests).

It prints one JSON line of kernel numbers and, last, one JSON line naming
the device.  With no GPU it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

# Main-path configuration: ResNet-50, s2d_fused stem, per-rank batch 256.
BATCH = 256
IMAGE = 224
WARMUP_STEPS = 3
TIMED_STEPS = 10
# Card roofline (NVIDIA H100 SXM data sheet): HBM bytes/s and float32
# non-tensor-core operations/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, warmup: int = 3, runs: int = 25) -> float:
    """Median milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch.cuda.get_device_name(): {torch.cuda.get_device_name(0)} "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda})",
          flush=True)
    return smi


def phase_build() -> None:
    from horovod_tpu_torch.ops import _build
    t0 = time.perf_counter()
    per_source = _build.build_all()
    print(f"build: {json.dumps(per_source)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def _stem_inputs(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    c = shape[-1]
    scale = torch.randn(c, generator=g, device="cuda") + 0.5
    offset = torch.randn(c, generator=g, device="cuda")
    return x, scale, offset


def phase_kernel_check() -> dict:
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import fused_stem
    from horovod_tpu_torch.ops.fused_stem import _tail, fused_bn_relu_maxpool

    main_shape = (BATCH, IMAGE // 2, IMAGE // 2, 64)
    cases = [(main_shape, torch.bfloat16), ((2, 8, 8, 4), torch.float32),
             ((3, 12, 16, 8), torch.float32),
             ((3, 12, 16, 8), torch.bfloat16),
             ((1, 6, 10, 3), torch.float32)]
    main_err = None
    for i, (shape, dtype) in enumerate(cases):
        x, scale, offset = _stem_inputs(shape, dtype, seed=i)
        before = fused_stem.launches.count
        out = fused_bn_relu_maxpool(x, scale, offset)
        ref = _tail(x, scale.to(dtype), offset.to(dtype))
        torch.cuda.synchronize()
        check(fused_stem.launches.count == before + 1,
              f"fused_stem did not launch at {shape}")
        err = (out.float() - ref.float()).abs().max().item()
        check(torch.equal(out, ref),
              f"fused_stem != plain at {shape} {dtype}: max err {err}")
        print(f"fused_stem {shape} {str(dtype)[6:]}: bitwise equal to the "
              f"plain version", flush=True)
        if shape == main_shape:
            main_err = err
        del x, out, ref

    # Gradients through the Function equal autograd through _tail.
    for shape, dtype in (((3, 12, 16, 8), torch.float32),
                         ((3, 12, 16, 8), torch.bfloat16),
                         ((2, 16, 16, 64), torch.bfloat16)):
        x, scale, offset = _stem_inputs(shape, dtype, seed=7)
        g = torch.randn(shape[0], shape[1] // 2, shape[2] // 2, shape[3],
                        device="cuda").to(dtype)
        leaves = [t.clone().requires_grad_() for t in (x, scale, offset)]
        ga = torch.autograd.grad(fused_bn_relu_maxpool(*leaves), leaves, g)
        leaves = [t.clone().requires_grad_() for t in (x, scale, offset)]
        gb = torch.autograd.grad(
            _tail(leaves[0], leaves[1].to(dtype), leaves[2].to(dtype)),
            leaves, g)
        for name, a, b in zip(("x", "scale", "offset"), ga, gb):
            check(torch.equal(a, b), f"fused_stem grad {name} differs at "
                  f"{shape} {dtype}: {(a - b).abs().max().item()}")
        print(f"fused_stem grads {shape} {str(dtype)[6:]}: equal to "
              f"autograd through the plain version", flush=True)

    # Time at the main-path shape.
    x, scale, offset = _stem_inputs(main_shape, torch.bfloat16, seed=0)
    s, o = scale.to(x.dtype), offset.to(x.dtype)
    xc = x.permute(0, 3, 1, 2)       # the channels_last NCHW view
    s4, o4 = s.view(1, -1, 1, 1), o.view(1, -1, 1, 1)
    kernel_ms = time_ms(lambda: fused_bn_relu_maxpool(x, scale, offset))
    plain_ms = time_ms(lambda: _tail(x, s, o))
    ops_ms = time_ms(lambda: F.max_pool2d(F.relu(xc * s4 + o4), 3, 2, 1))
    n_in = x.numel()
    n_out = n_in // 4
    nbytes = (n_in + n_out + 2 * x.shape[-1]) * x.element_size()
    # mul, add, relu per input element; 8 compares per output's 9 taps.
    ops = 3 * n_in + 8 * n_out
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_bound_ms = ops / F32_OPS_PER_S * 1e3
    row = {
        "name": "fused_stem",
        "route": "cuda",
        "source": "horovod_tpu_torch/ops/csrc/fused_stem.cu",
        "replaces": "horovod_tpu/ops/fused_stem.py:67",
        "launches": None,
        "max_abs_err": main_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_bound_ms),
        "bound_by": "bytes" if bytes_ms >= ops_bound_ms else "operations",
        "library_ms": None,
        "kernel_ms": kernel_ms,
        "torch_ops_ms": ops_ms,
    }
    print(f"fused_stem at {list(main_shape)} bf16: kernel {kernel_ms:.4f} "
          f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
          f"{nbytes} bytes, {ops} operations), "
          f"plain {plain_ms:.4f} ms, three-op composition "
          f"max_pool2d(relu(x*s+b)) {ops_ms:.4f} ms", flush=True)
    return row


def phase_main_path(smi: str) -> tuple:
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.benchmark import run_synthetic_benchmark
    from horovod_tpu_torch.ops import fused_stem, fusion

    hvd.init()
    check(dist.get_backend() == "nccl",
          f"process group backend is {dist.get_backend()}, not nccl")
    check(hvd.size() == 1 and hvd.device() == torch.device("cuda", 0),
          f"expected one rank on cuda:0, got size {hvd.size()} on "
          f"{hvd.device()}")
    fused_stem.launches.reset()
    fusion.allreduce_calls.reset()
    res = run_synthetic_benchmark(
        "resnet50", batch_size=BATCH, image_size=IMAGE, stem="s2d_fused",
        input_dtype="bfloat16", num_warmup_batches=WARMUP_STEPS,
        num_batches_per_iter=1, num_iters=TIMED_STEPS)
    launches = fused_stem.launches.count
    calls = fusion.allreduce_calls.count
    steps = WARMUP_STEPS + TIMED_STEPS
    for i, loss in enumerate(res["step_losses"]):
        check(loss == loss and abs(loss) != float("inf"),
              f"step {i} loss is not finite: {loss}")
        print(f"step {i}: loss {loss:.6f} finite", flush=True)
    check(len(res["step_losses"]) == TIMED_STEPS, "missing step losses")
    check(launches == steps,
          f"fused_stem launched {launches} times in {steps} forward passes")
    check(calls >= steps and calls % steps == 0,
          f"fusion all_reduce calls {calls} over {steps} steps")
    print(f"fused_stem launches {launches} = forward passes {steps}; "
          f"fusion all_reduce calls {calls} on {dist.get_backend()} "
          f"({calls // steps} bucket(s) per step)", flush=True)
    summary = {k: res[k] for k in (
        "model", "stem", "batch_size_per_chip", "n_chips", "device",
        "img_sec_total", "img_sec_conf", "ms_per_step", "tflops_per_chip",
        "peak_tflops", "mfu", "max_memory_allocated")}
    summary["nvidia_smi"] = smi
    print("main path: " + json.dumps(summary), flush=True)
    return launches, calls // steps


def phase_reference() -> None:
    """A small ResNet's train step on the GPU against the CPU."""
    import torch.distributed as dist

    from horovod_tpu_torch.benchmark import make_train_step
    from horovod_tpu_torch.models.resnet import BasicBlock, ResNet
    from horovod_tpu_torch.topology import build_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gloo = dist.new_group(backend="gloo")
    rng = torch.Generator().manual_seed(3)
    images = torch.randn(4, 8, 8, 12, generator=rng)
    labels = torch.randint(0, 5, (4,), generator=rng)
    out = {}
    for dev, group in (("cuda", None), ("cpu", gloo)):
        model = ResNet(stage_sizes=[1, 1], block_cls=BasicBlock,
                       num_classes=5, num_filters=16, stem="s2d_fused",
                       dtype=torch.float32,
                       generator=torch.Generator().manual_seed(0),
                       device=dev)
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        step = make_train_step(model, opt, build_mesh(group, dev))
        loss = step(images.to(dev), labels.to(dev))
        out[dev] = (float(loss), {k: v.detach().cpu()
                                  for k, v in model.state_dict().items()})
    (lg, sg), (lc, sc) = out["cuda"], out["cpu"]
    check(abs(lg - lc) <= 1e-5 * max(1.0, abs(lc)),
          f"small-model loss gpu {lg} vs cpu {lc}")
    worst = max((sg[k] - sc[k]).abs().max().item() for k in sc)
    check(worst <= 1e-4, f"small-model state after one step differs by "
          f"{worst} between gpu and cpu")
    print(f"reference: small s2d_fused ResNet step, gpu loss {lg:.6f} vs "
          f"cpu {lc:.6f}; state max abs diff {worst:.3g} (tolerance 1e-4, "
          f"TF32 off)", flush=True)
    dist.destroy_process_group(gloo)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import horovod_tpu_torch as hvd

    smi = phase_card()
    phase_build()
    row = phase_kernel_check()
    launches, _ = phase_main_path(smi)
    phase_reference()
    row["launches"] = launches
    hvd.shutdown()
    print(smi, flush=True)
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
