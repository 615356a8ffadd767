#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (``/usr/local/cuda``).  Phases, in order;
any failure ends the run with a traceback and a non-zero exit:

1. card: the GPU's name and power limit as nvidia-smi reports them;
2. build: every kernel under ``horovod_tpu_torch/ops/csrc`` with nvcc;
3. kernel check: the fused stem against its plain PyTorch version on
   the card (bitwise, at the main shape and at small ones that cut its
   strips and column tiles short), gradients through its autograd
   Function, and its time beside the plain version's and the least time
   the card could take;
4. main path: ``hvd.init()`` (an NCCL group of size 1) and the ResNet-50
   ``s2d_fused`` synthetic training benchmark at 224x224, full width,
   bf16, with the kernel and collective counts read around it;
5. reference: a small ResNet's train step on the GPU against the same step
   on the CPU (the CPU port is held against the JAX package by the tests);
6. flash kernel check: the forward, dQ and dK/dV flash-attention kernels
   against their plain PyTorch versions in bf16, row by row, at the LM's
   shape and at small ones (non-causal, a custom scale, segment ids with a
   fully masked row, ragged T, tiles half empty or cut by T or by segment
   borders, every head dim), the autograd Function's output and
   gradients against the plain versions, and each kernel's time
   beside its bound, its plain version's and
   ``scaled_dot_product_attention``'s;
7. LM main path: the transformer-LM benchmark of record (``bench.py``'s
   d3072/L10/H24, T 2048, batch 4, flash attention, bf16 momentum) for 2
   warmup and 10 timed steps, with the flash launch counts read around it;
8. LM reference: a small f32 LM step on the GPU against the CPU, and a
   small packed bf16 LM's logits and gradients through the flash route
   against the local one;
9. the ``hvd.*`` API on the card (the NCCL group of size 1): every
   collective on CUDA tensors in f32, bf16, f16, int32 and int64 (a
   0-dim and an empty tensor too) against its size-1 result, the async
   handles, the object ops and a process set; then the ResNet-50
   ``s2d_fused`` step of phase 4 through ``hvd.DistributedOptimizer``,
   ``hvd.broadcast_parameters`` and ``hvd.broadcast_optimizer_state``,
   with the fused-stem launches read around it and its losses held to
   phase 4's;
10. the control plane on the card (its thread, ready events, fusion and
   NCCL launch at size 1): every eager op through the runtime on CUDA
   tensors in f32, bf16 and int32, names submitted in an order reversed
   on every other call, each result held to its size-1 result, and
   ``join``; then phase 4's ResNet-50 ``s2d_fused`` step with every
   gradient submitted as a named ``allreduce_async(op=Average)`` from
   its autograd hook, in the order autograd produces them, and
   synchronized before the SGD update, with the fused-stem launches read
   around it, its losses held to phase 4's bit for bit (Average at size 1
   divides by one) and its ms/step, cycles, fused all-reduces and ms per
   cycle printed beside phase 4's ms/step.

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
# LM main path: the benchmark of record (bench.py:133-144), full width and
# depth, per-rank batch 4.
LM = dict(d_model=3072, n_layers=10, n_heads=24, d_ff=12288,
          vocab_size=32768, seq_len=2048, batch_size=4)
LM_WARMUP_STEPS = 2
LM_TIMED_STEPS = 10
# First and last timed LM loss with the earlier wmma forward and dK/dV
# kernels (same seeds), printed beside this run's for the record: the
# summation order differs, so they are not expected bit for bit.
LM_WMMA_LOSSES = (10.997063, 10.953733)
# Card roofline (NVIDIA H100 SXM data sheet): HBM bytes/s, float32
# non-tensor-core operations/s and dense bf16 tensor-core operations/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# Flash tolerances (bf16 operands, f32 accumulation).  o, dq, dk and dv
# are held row by row, a row being the D values of one (batch*head,
# position):  ||a_r - b_r|| <= FLASH_ROW_RTOL * ||b_r|| + FLASH_ROW_ATOL *
# median_r ||b_r||.  Under causal masking the rows of late queries and
# keys are 30-50x smaller than the first ones, so one limit scaled by the
# whole tensor's largest value would pass a kernel that is wrong on every
# late tile; this one scales with each row.  The median term is the floor
# for rows that cancel to about 0 in exact arithmetic (dq of a segment's
# first query).  Also o max abs <= FLASH_O_TOL, and m and l relative to
# max(1, |ref|) <= FLASH_ML_TOL.
FLASH_ROW_RTOL = 2 ** -6
FLASH_ROW_ATOL = 2 ** -8
FLASH_O_TOL = 2e-2
FLASH_ML_TOL = 1e-4
# The flash route in a small bf16 LM against the local route: logits row
# by row (one row per token), ||a_r - b_r|| / ||b_r||, and loss_fn's
# gradients leaf by leaf, ||a - b|| / ||b||.  The local route rounds its
# scores and probabilities to bf16, so it is the noisier of the two.
LM_LOGIT_TOL = 2 ** -5
LM_GRAD_TOL = 2 ** -4
# Phase 9 runs phase 4's step (same seed, batch and SGD) through
# hvd.DistributedOptimizer, which at size 1 adds no hook and no
# collective, after broadcast_optimizer_state's zero-gradient fill (which
# leaves parameters and momentum as a fresh start has them).  The math is
# the same and cuDNN picks the same algorithms for the same shapes, so
# every timed loss must equal phase 4's bit for bit.


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
             ((1, 6, 10, 3), torch.float32),
             # The kernel's strips and column tiles: H = 2, a last strip
             # cut short (Ho = 59), W = 2, rows too wide for one strip in
             # both dtypes, and C = 24 bf16 (three 16-byte groups).
             ((2, 2, 8, 64), torch.bfloat16),
             ((1, 118, 112, 64), torch.bfloat16),
             ((2, 8, 2, 16), torch.bfloat16),
             ((1, 16, 448, 64), torch.bfloat16),
             ((2, 20, 112, 64), torch.float32),
             ((2, 12, 16, 24), torch.bfloat16)]
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
    summary["step_losses"] = res["step_losses"]
    return launches, calls // steps, summary


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


# ---------------------------------------------------------------------------
# Flash attention and the transformer LM
# ---------------------------------------------------------------------------

def _bf16(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _max_abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _rel_to_one(a, b) -> float:
    """max |a - b| / max(1, |b|), elementwise (m is often near 0)."""
    a, b = a.float(), b.float()
    both_inf = (a == b)
    err = ((a - b).abs() / b.abs().clamp_min(1.0)).masked_fill(both_inf, 0.0)
    return err.max().item()


def _row_ratio(a, b) -> float:
    """The worst row's ||a_r - b_r|| over its limit FLASH_ROW_RTOL *
    ||b_r|| + FLASH_ROW_ATOL * median_r ||b_r||, rows along the last
    dimension; the check passes at <= 1."""
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    err, ref = (a - b).norm(dim=-1), b.norm(dim=-1)
    limit = FLASH_ROW_RTOL * ref + FLASH_ROW_ATOL * ref.median()
    return torch.where(err == 0, 0.0, err / limit).max().item()


def _segments(b, t, lengths, device="cuda"):
    ids = torch.repeat_interleave(torch.arange(len(lengths)),
                                  torch.tensor(lengths))
    check(ids.numel() == t, f"segment lengths {lengths} do not sum to {t}")
    return ids[None].repeat(b, 1).to(device=device, dtype=torch.int32)


def _flash_case(fa, b, t, h, d, causal, scale, qseg, kseg, seed, label):
    """One shape: the three kernels against their plain versions on the
    same inputs; returns the errors by name and the inputs."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (_bf16((b * h, t, d), gen) for _ in range(4))
    sc = d ** -0.5 if scale is None else scale
    before = (fa.fwd_launches.count, fa.dq_launches.count,
              fa.dkv_launches.count)
    o, m, l = fa._fwd_parts(q, k, v, qseg, kseg, causal, sc)
    ro, rm, rl = fa._fwd_parts_plain(q, k, v, qseg, kseg, causal, sc)
    dq = fa._launch_dq(q, k, v, ro, do, rm, rl, qseg, kseg, causal, sc)
    dk, dv = fa._launch_dkv(q, k, v, ro, do, rm, rl, qseg, kseg, causal,
                            sc)
    rdq = fa._bwd_dq_plain(q, k, v, ro, do, rm, rl, qseg, kseg, causal, sc)
    rdk, rdv = fa._bwd_dkv_plain(q, k, v, ro, do, rm, rl, qseg, kseg,
                                 causal, sc)
    torch.cuda.synchronize()
    after = (fa.fwd_launches.count, fa.dq_launches.count,
             fa.dkv_launches.count)
    check(after == tuple(x + 1 for x in before),
          f"flash {label}: launches {before} -> {after}")
    for name, x in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        check(bool(torch.isfinite(x).all()), f"flash {label}: {name} has "
              f"non-finite values")
    errs = {
        "o": _max_abs(o, ro),
        "ml": max(_rel_to_one(m, rm), _rel_to_one(l, rl)),
        "dq_abs": _max_abs(dq, rdq),
        "dkv_abs": max(_max_abs(dk, rdk), _max_abs(dv, rdv)),
    }
    rows = {"o": _row_ratio(o, ro), "dq": _row_ratio(dq, rdq),
            "dk": _row_ratio(dk, rdk), "dv": _row_ratio(dv, rdv)}
    check(errs["o"] <= FLASH_O_TOL, f"flash {label}: o err {errs['o']}")
    check(errs["ml"] <= FLASH_ML_TOL, f"flash {label}: m/l err "
          f"{errs['ml']}")
    for name, ratio in rows.items():
        check(ratio <= 1.0, f"flash {label}: {name} row error at {ratio:.3g}"
              f" x its limit")
    print(f"flash {label} [B*H={b * h}, T={t}, D={d}] causal={causal} "
          f"scale={sc:.4g}: o max abs {errs['o']:.3g}, m/l rel "
          f"{errs['ml']:.3g}; worst row / limit: " + ", ".join(
              f"{n} {r:.3g}" for n, r in rows.items()), flush=True)
    return errs, (q, k, v, do)


def _flash_grad_case(fa, b, t, h, d, seg, seed, label):
    """The autograd Function ([B, T, H, D] read in place): its o against
    the plain forward, and its gradients against the plain backward fed
    the o the Function saved.  The backward takes di = rowsum(dO*O) from
    that bf16 o, as the TPU kernels do, so a reference with another o (the
    plain forward's, which differs by rounding flips, or autograd's f32
    one) moves di on rows whose attention sits on one key by several
    times the row limit."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (_bf16((b, t, h, d), gen) for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True, block_q=64, block_k=64,
                             segment_ids=seg)
    got = torch.autograd.grad(out, leaves, g)
    qf, kf, vf, gf = (fa._fold(x) for x in (q, k, v, g))
    ro, rm, rl = fa._fwd_parts_plain(qf, kf, vf, seg, seg, True, d ** -0.5)
    want = fa._bwd_parts_plain(qf, kf, vf, fa._fold(out.detach()), gf, rm,
                               rl, seg, seg, True, d ** -0.5)
    err_o = _max_abs(fa._fold(out), ro)
    check(err_o <= FLASH_O_TOL, f"flash grads {label}: o err {err_o}")
    rows = {name: _row_ratio(fa._fold(a), w)
            for name, a, w in zip(("o", "dq", "dk", "dv"), (out,) + got,
                                  (ro,) + want)}
    for name, ratio in rows.items():
        check(ratio <= 1.0, f"flash grads {label}: {name} row error at "
              f"{ratio:.3g} x its limit")
    print(f"flash grads {label} [{b}, {t}, {h}, {d}]: Function vs the plain "
          f"versions; worst row / limit: " + ", ".join(
              f"{n} {r:.3g}" for n, r in rows.items()), flush=True)


def _attention_flops(b, t, h, d, causal, per_pair):
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    return per_pair * d * pairs


def _bound(flops, nbytes):
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def phase_flash_check() -> list:
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    b, t, h, d = LM["batch_size"], LM["seq_len"], LM["n_heads"], \
        LM["d_model"] // LM["n_heads"]
    main, (q, k, v, do) = _flash_case(fa, b, t, h, d, True, None, None,
                                      None, 11, "main shape")
    del q, k, v, do
    _flash_case(fa, 2, 64, 4, 64, False, None, None, None, 12,
                "non-causal T=64")
    _flash_case(fa, 2, 192, 3, 128, True, 0.3, None, None, 13,
                "custom scale T=192")
    seg = _segments(1, 2048, [700, 1000, 348])
    _flash_case(fa, 1, 2048, 2, 64, True, None, seg, seg, 14,
                "segments T=2048")
    # q-side segment 3 never appears on the k side: those rows are fully
    # masked (o = 0, zero gradients), as ring attention's rotated ids give.
    qseg = _segments(2, 192, [64, 64, 40, 24])
    kseg = _segments(2, 192, [64, 64, 64])
    _, (q, k, v, do) = _flash_case(fa, 2, 192, 2, 32, False, None, qseg,
                                   kseg, 15, "fully masked rows")
    o, m, l = fa._fwd_parts(q, k, v, qseg, kseg, False, 32 ** -0.5)
    dq = fa._launch_dq(q, k, v, o, do, m, l, qseg, kseg, False, 32 ** -0.5)
    dk, dv = fa._launch_dkv(q, k, v, o, do, m, l, qseg, kseg, False,
                            32 ** -0.5)
    masked = slice(168, 192)
    check(bool((o[:, masked] == 0).all()) and bool((l[:, 0, masked] ==
                                                     0).all()) and
          bool((dq[:, masked] == 0).all()),
          "fully masked rows must give o = 0, l = 0 and dq = 0")
    check(bool(torch.isfinite(dk).all()) and bool(torch.isfinite(dv).all()),
          "fully masked rows leave dk/dv finite")
    print("flash fully masked rows: o = 0, l = 0, dq = 0, dk/dv finite",
          flush=True)
    _flash_case(fa, 1, 40, 2, 16, True, None, None, None, 16,
                "ragged T=40")
    # The forward and dK/dV kernels tile by 128 rows or keys: a half-empty
    # tile, several tiles with a ragged end, the small head dims over two
    # tiles, segment borders inside a tile, and a non-causal ragged T.
    _flash_case(fa, 2, 64, 4, 64, True, None, None, None, 21, "causal T=64")
    _flash_case(fa, 2, 320, 2, 64, True, None, None, None, 22,
                "causal T=320")
    _flash_case(fa, 2, 256, 2, 16, True, None, None, None, 23,
                "D=16 causal T=256")
    _flash_case(fa, 2, 256, 2, 32, True, None, None, None, 24,
                "D=32 causal T=256")
    seg = _segments(2, 512, [100, 200, 150, 62])
    _flash_case(fa, 2, 512, 2, 64, True, None, seg, seg, 25,
                "segment borders inside tiles T=512")
    _flash_case(fa, 2, 192, 2, 128, False, None, None, None, 26,
                "non-causal T=192")
    _flash_grad_case(fa, 2, 256, 2, 128, None, 17, "T=256")
    _flash_grad_case(fa, 1, 192, 2, 64, _segments(1, 192, [100, 92]), 18,
                     "segments T=192")
    _flash_grad_case(fa, b, t, h, d, None, 19, "main shape")

    # Times at the main-path shape and layout ([B, T, H, D] in place).
    gen = torch.Generator(device="cuda").manual_seed(20)
    q, k, v, do = (_bf16((b, t, h, d), gen) for _ in range(4))
    sc = d ** -0.5
    o, m, l = fa._launch_fwd(q, k, v, None, None, True, sc)
    qf, kf, vf, of, dof = (fa._fold(x).contiguous() for x in (q, k, v, o,
                                                             do))
    ms = {
        "fwd": time_ms(lambda: fa._launch_fwd(q, k, v, None, None, True,
                                              sc)),
        "dq": time_ms(lambda: fa._launch_dq(q, k, v, o, do, m, l, None,
                                            None, True, sc)),
        "dkv": time_ms(lambda: fa._launch_dkv(q, k, v, o, do, m, l, None,
                                              None, True, sc)),
    }
    plain_ms = {
        "fwd": time_ms(lambda: fa._fwd_parts_plain(qf, kf, vf, None, None,
                                                   True, sc), runs=10),
        "dq": time_ms(lambda: fa._bwd_dq_plain(qf, kf, vf, of, dof, m, l,
                                               None, None, True, sc),
                      runs=10),
        "dkv": time_ms(lambda: fa._bwd_dkv_plain(qf, kf, vf, of, dof, m, l,
                                                 None, None, True, sc),
                       runs=10),
    }
    del qf, kf, vf, of, dof
    # The library call that computes the same function: SDPA, [B, H, T,
    # D].  Timed here as a yardstick; the port never calls it.
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v,
                                                               do))
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True))
    leaves = [x.clone().requires_grad_() for x in (qh, kh, vh)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(out, leaves, doh,
                                                   retain_graph=True))
    sdpa_fwd_bwd = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves, is_causal=True), leaves,
        doh))
    del out, leaves
    n = b * t * h * d * 2                    # bytes of one bf16 operand
    ml = 2 * b * h * t * 4                   # m and l, f32
    work = {
        "fwd": (_attention_flops(b, t, h, d, True, 4), 4 * n + ml),
        "dq": (_attention_flops(b, t, h, d, True, 6), 6 * n + ml),
        "dkv": (_attention_flops(b, t, h, d, True, 8), 7 * n + ml),
    }
    rows = []
    for key, name, line, err in (
            ("fwd", "flash_attention_fwd", 108, main["o"]),
            ("dq", "flash_attention_bwd_dq", 173, main["dq_abs"]),
            ("dkv", "flash_attention_bwd_dkv", 226, main["dkv_abs"])):
        bound_ms, bound_by = _bound(*work[key])
        rows.append({
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": f"horovod_tpu/ops/flash_attention.py:{line}",
            "launches": None, "max_abs_err": err, "ms": ms[key],
            "plain_ms": plain_ms[key], "bound_ms": bound_ms,
            "bound_by": bound_by,
            # dq and dkv share SDPA's one backward time.
            "library_ms": sdpa_fwd if key == "fwd" else sdpa_bwd,
            "flops": work[key][0], "bytes": work[key][1],
        })
        print(f"{name} at [{b}, {t}, {h}, {d}] bf16 causal: kernel "
              f"{ms[key]:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{work[key][0]:.4g} FLOP, {work[key][1]} bytes; "
              f"{bound_ms / ms[key] * 100:.1f} % of bound), plain "
              f"{plain_ms[key]:.4f} ms", flush=True)
    print(f"scaled_dot_product_attention at [{b}, {h}, {t}, {d}] bf16 "
          f"causal: forward {sdpa_fwd:.4f} ms, backward {sdpa_bwd:.4f} ms, "
          f"forward+backward {sdpa_fwd_bwd:.4f} ms", flush=True)
    return rows


def phase_lm_main_path(smi: str) -> dict:
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.benchmark import run_lm_benchmark
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fusion

    hvd.init()
    check(dist.get_backend() == "nccl",
          f"process group backend is {dist.get_backend()}, not nccl")
    torch.cuda.empty_cache()
    counters = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    for c in counters:
        c.reset()
    fusion.allreduce_calls.reset()
    res = run_lm_benchmark(
        **LM, attention="flash", remat="none", momentum_dtype="bfloat16",
        num_warmup_batches=LM_WARMUP_STEPS, num_batches_per_iter=1,
        num_iters=LM_TIMED_STEPS)
    counts = {c.name: c.count for c in counters}
    calls = fusion.allreduce_calls.count
    steps = LM_WARMUP_STEPS + LM_TIMED_STEPS
    for i, loss in enumerate(res["step_losses"]):
        check(loss == loss and abs(loss) != float("inf"),
              f"LM step {i} loss is not finite: {loss}")
    check(len(res["step_losses"]) == LM_TIMED_STEPS, "missing LM losses")
    want = LM["n_layers"] * steps
    for name, count in counts.items():
        check(count == want, f"{name} launched {count} times; expected "
              f"{LM['n_layers']} layers x {steps} steps = {want}")
    check(calls >= steps and calls % steps == 0,
          f"fusion all_reduce calls {calls} over {steps} LM steps")
    print(f"LM losses finite: {res['step_losses'][0]:.6f} -> "
          f"{res['step_losses'][-1]:.6f} (wmma kernels: "
          f"{LM_WMMA_LOSSES[0]:.6f} -> {LM_WMMA_LOSSES[1]:.6f}); "
          f"flash launches {counts} = "
          f"{LM['n_layers']} per step x {steps} steps; fusion all_reduce "
          f"calls {calls} ({calls // steps} bucket(s) per step)", flush=True)
    summary = {k: res[k] for k in (
        "d_model", "n_layers", "n_heads", "d_ff", "vocab_size", "seq_len",
        "batch_size", "attention", "momentum_dtype", "device",
        "tok_sec_per_chip", "tok_sec_conf", "ms_per_step",
        "flops_per_step_analytic", "tflops_per_chip", "peak_tflops", "mfu",
        "max_memory_allocated")}
    summary["nvidia_smi"] = smi
    print("LM main path: " + json.dumps(summary), flush=True)
    return counts


def _small_lm_params(cfg, seed):
    """A seeded LM parameter tree (numpy), as the port's state_dict."""
    import numpy as np

    from horovod_tpu_torch.models.convert import lm_params_to_torch

    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, cfg.d_ff

    def dense(shape, scale=None):
        return rng.standard_normal(shape) * (scale or shape[0] ** -0.5)

    def norm():
        return 1.0 + 0.2 * rng.standard_normal(d)

    return lm_params_to_torch({
        "embed": dense((cfg.vocab_size, d), 0.02),
        "pos": dense((cfg.max_seq, d), 0.02),
        "ln_f_scale": norm(),
        "layers": [{"ln1_scale": norm(), "ln2_scale": norm(),
                    "wq": dense((d, d)), "wk": dense((d, d)),
                    "wv": dense((d, d)), "wo": dense((d, d)),
                    "w1": dense((d, f)), "w2": dense((f, d))}
                   for _ in range(cfg.n_layers)],
    })


def phase_lm_reference() -> None:
    """A small f32 LM step on the GPU against the CPU, and a small bf16
    LM's logits and gradients through the flash route against the local
    one, on the GPU."""
    import numpy as np
    import torch.distributed as dist

    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.models.convert import lm_ordered_parameters
    from horovod_tpu_torch.optim import SGD
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.topology import build_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tfm.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                                n_layers=2, d_ff=64, max_seq=32,
                                dtype=torch.float32)
    sd = _small_lm_params(cfg, 0)
    toks = np.random.default_rng(1).integers(0, 64, (2, 33))
    tokens, labels = (torch.from_numpy(x.copy()) for x in (toks[:, :-1],
                                                          toks[:, 1:]))
    gloo = dist.new_group(backend="gloo")
    out = {}
    for dev, group in (("cuda", None), ("cpu", gloo)):
        model = tfm.TransformerLM(cfg, device=dev)
        model.load_state_dict(sd)
        opt = SGD([p for _, p in lm_ordered_parameters(model)], 0.1, 0.9,
                  torch.bfloat16)
        step = tfm.make_train_step(model, opt, build_mesh(group, dev),
                                   attention="local")
        loss = step(tokens.to(dev), labels.to(dev))
        loss2 = step(tokens.to(dev), labels.to(dev))
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        state.update({f"trace{i}": t.float().cpu()
                      for i, t in enumerate(opt.trace)})
        out[dev] = (float(loss), float(loss2), state)
    (lg, lg2, sg), (lc, lc2, sc) = out["cuda"], out["cpu"]
    for a, c in ((lg, lc), (lg2, lc2)):
        check(abs(a - c) <= 1e-5 * max(1.0, abs(c)),
              f"small LM loss gpu {a} vs cpu {c}")
    worst = max((sg[k] - sc[k]).abs().max().item() for k in sc)
    check(worst <= 1e-4, f"small LM state after two steps differs by "
          f"{worst} between gpu and cpu")
    print(f"LM reference: small f32 LM, two steps, gpu losses {lg:.6f} "
          f"{lg2:.6f} vs cpu {lc:.6f} {lc2:.6f}; params and bf16 momentum "
          f"max abs diff {worst:.3g} (tolerance 1e-4, TF32 off)", flush=True)
    dist.destroy_process_group(gloo)

    # The flash route inside the model ([B, T, H, D] read in place, the
    # segment ids passed through) against the local route, both bf16 on
    # the GPU, packed, the same weights.  The loss alone has no power here
    # (about ln 512 at random init whatever attention returns), so the
    # logits and the gradients are compared; the loss is printed only.
    cfg = tfm.TransformerConfig(vocab_size=512, d_model=256, n_heads=2,
                                n_layers=2, d_ff=512, max_seq=256,
                                dtype=torch.bfloat16)
    model = tfm.TransformerLM(cfg, generator=torch.Generator(
        device="cuda").manual_seed(2), device="cuda")
    leaves = [p for _, p in lm_ordered_parameters(model)]
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (2, 257))).cuda()
    seg = _segments(2, 256, [100, 60, 96])
    counters = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    before = [c.count for c in counters]
    out = {}
    for route in ("flash", "local"):
        logits = tfm.forward(model.tree(), toks[:, :-1], cfg,
                             attention=route, segment_ids=seg)
        loss = tfm.xent(logits, toks[:, 1:])
        out[route] = (logits.detach(), float(loss.detach()),
                      torch.autograd.grad(loss, leaves))
    check([c.count - n for c, n in zip(counters, before)] ==
          [cfg.n_layers] * 3, "the flash route did not launch the forward, "
          "dq and dkv kernels once per layer")
    (lf, loss_f, gf), (ll, loss_l, gl) = out["flash"], out["local"]
    logit_err = ((lf - ll).norm(dim=-1) / ll.norm(dim=-1)).max().item()
    grad_err = {name: ((a - b).norm() / b.norm()).item()
                for (name, _), a, b in zip(lm_ordered_parameters(model), gf,
                                           gl)}
    worst = max(grad_err, key=grad_err.get)
    check(logit_err <= LM_LOGIT_TOL, f"small bf16 LM logits flash vs local:"
          f" worst row {logit_err:.3g} > {LM_LOGIT_TOL}")
    check(grad_err[worst] <= LM_GRAD_TOL, f"small bf16 LM grads flash vs "
          f"local: {worst} {grad_err[worst]:.3g} > {LM_GRAD_TOL}")
    print(f"LM reference: small packed bf16 LM on the GPU, flash vs local "
          f"route: logits worst row {logit_err:.3g} (max abs "
          f"{_max_abs(lf, ll):.3g}; tolerance {LM_LOGIT_TOL}), grads worst "
          f"leaf {worst} {grad_err[worst]:.3g} (median "
          f"{statistics.median(grad_err.values()):.3g}; tolerance "
          f"{LM_GRAD_TOL}); loss {loss_f:.6f} vs {loss_l:.6f}", flush=True)


# ---------------------------------------------------------------------------
# The hvd.* API
# ---------------------------------------------------------------------------

def _hvd_ops(hvd, x, ps):
    """Every collective of the API on ``x`` at size 1, by name."""
    out = {
        "allreduce": hvd.allreduce(x),
        "allreduce Sum": hvd.allreduce(x, op=hvd.Sum),
        "allreduce Min": hvd.allreduce(x, op=hvd.Min),
        "allreduce Max": hvd.allreduce(x, op=hvd.Max),
        "allreduce process_set": hvd.allreduce(x, process_set=ps),
        "allreduce_": hvd.allreduce_(x.clone()),
        "grouped_allreduce": hvd.grouped_allreduce([x, x])[1],
        "allgather": hvd.allgather(x),
        "broadcast": hvd.broadcast(x, 0),
        "broadcast_": hvd.broadcast_(x.clone(), 0),
        "allreduce_async": hvd.synchronize(hvd.allreduce_async(x)),
        "allreduce_async_": hvd.synchronize(hvd.allreduce_async_(
            x.clone())),
        "grouped_allreduce_async": hvd.synchronize(
            hvd.grouped_allreduce_async([x, x]))[0],
        "allgather_async": hvd.synchronize(hvd.allgather_async(x)),
        "broadcast_async": hvd.synchronize(hvd.broadcast_async(x, 0)),
        "broadcast_async_": hvd.synchronize(hvd.broadcast_async_(
            x.clone(), 0)),
    }
    if x.dim():
        out["reducescatter"] = hvd.reducescatter(x)
        out["alltoall"] = hvd.alltoall(x)
        out["alltoall splits"] = hvd.alltoall(x, splits=[x.shape[0]])[0]
    if x.is_floating_point():
        out["allreduce Adasum"] = hvd.allreduce(x, op=hvd.Adasum)
    return out


def phase_hvd_api(smi: str, main: dict) -> None:
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.benchmark import make_bench_state
    from horovod_tpu_torch.ops import collective, fused_stem, fusion

    dev = torch.device("cuda", 0)
    check(hvd.size() == 1 and hvd.device() == dev and hvd.nccl_built(),
          f"expected an NCCL world of one on cuda:0, got size {hvd.size()} "
          f"on {hvd.device()}")
    torch.cuda.empty_cache()
    collective.calls.reset()
    fusion.allreduce_calls.reset()
    ps = hvd.add_process_set([0])
    checked, names = 0, set()
    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.int32,
                  torch.int64):
        base = torch.arange(-6, 6, device=dev).reshape(3, 4).to(dtype)
        for x in (base, base[1, 2].clone(), base[:0]):
            for name, got in _hvd_ops(hvd, x, ps).items():
                names.add(name)
                check(got.device == dev and got.dtype == dtype
                      and got.shape == x.shape and torch.equal(got, x),
                      f"hvd.{name} on {tuple(x.shape)} {dtype}: got "
                      f"{tuple(got.shape)} {got.dtype} on {got.device}")
                checked += 1
        if dtype.is_floating_point:
            # Average with scale factors, as the reference's size-1 eager
            # plane computes it: x * 0.5 / 1 * 3, exact for these values.
            got = hvd.allreduce(base, prescale_factor=0.5,
                                postscale_factor=3.0)
            want = (base.double() * 1.5).to(dtype)
            check(got.dtype == dtype and torch.equal(got, want),
                  f"hvd.allreduce pre/postscale {dtype}: {got} != {want}")
            h = hvd.allreduce_async(base, op=hvd.Sum)
            check(isinstance(hvd.poll(h), bool), "hvd.poll")
            check(torch.equal(hvd.synchronize(h), base), "hvd.synchronize")
            checked += 2
    obj = {"phase": 9, "ranks": [0]}
    check(hvd.broadcast_object(obj) == obj, "hvd.broadcast_object")
    check(hvd.allgather_object(obj) == [obj], "hvd.allgather_object")
    hvd.barrier()
    torch.cuda.synchronize()
    print(f"hvd API: {checked + 2} checks of {len(names)} ops x 5 dtypes x "
          f"(2-D, 0-dim, empty) on cuda:0 over NCCL: results on the "
          f"device, in the input's dtype, equal to the size-1 result; "
          f"{collective.calls.count} collective calls and "
          f"{fusion.allreduce_calls.count} bucket all-reduces", flush=True)

    # Phase 4's step through the DistributedOptimizer recipe.
    st = make_bench_state("resnet50", batch_size=BATCH, image_size=IMAGE,
                          stem="s2d_fused", input_dtype="bfloat16")
    model = st.model
    opt = hvd.DistributedOptimizer(
        st.optimizer, named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

    def step():
        model.train()
        loss = F.cross_entropy(model(st.images), st.labels)
        loss.backward()
        opt.step()
        opt.zero_grad()
        return loss.detach()

    fused_stem.launches.reset()
    collective.calls.reset()
    fusion.allreduce_calls.reset()
    losses = [step() for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    losses += [step() for _ in range(TIMED_STEPS)]
    t1.record()
    torch.cuda.synchronize()
    launches = fused_stem.launches.count
    calls = collective.calls.count + fusion.allreduce_calls.count
    steps = WARMUP_STEPS + TIMED_STEPS
    losses = [float(x) for x in losses]
    for i, loss in enumerate(losses):
        check(loss == loss and abs(loss) != float("inf"),
              f"phase 9 step {i} loss is not finite: {loss}")
    check(launches == steps, f"fused_stem launched {launches} times in "
          f"phase 9's {steps} forward passes")
    timed = losses[WARMUP_STEPS:]
    check(len(timed) == len(main["step_losses"]) == TIMED_STEPS,
          "phase 9: missing timed losses")
    diffs = [abs(a - b) for a, b in zip(timed, main["step_losses"])]
    check(timed == main["step_losses"],
          f"phase 9 timed losses {timed} differ from phase 4's "
          f"{main['step_losses']} (|diff| {diffs})")
    ms = t0.elapsed_time(t1) / TIMED_STEPS
    print(f"hvd DistributedOptimizer ResNet-50 s2d_fused, batch {BATCH}: "
          f"{BATCH / ms * 1e3:.1f} img/s, {ms:.2f} ms/step (phase 4: "
          f"{main['img_sec_total']:.1f} img/s, {main['ms_per_step']:.2f} "
          f"ms/step) on {smi}; fused_stem launches {launches} = forward "
          f"passes {steps}; {calls} collective calls in the steps (size 1: "
          f"no hook, no all-reduce); the {TIMED_STEPS} timed losses "
          f"{timed[0]:.6f} -> {timed[-1]:.6f} equal phase 4's bit for bit",
          flush=True)
    del st, model, opt
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The control plane
# ---------------------------------------------------------------------------

def _submit_all(hvd, x, tag, order):
    """One async op of each kind per index of ``order``, in that order;
    their results by (kind, index)."""
    handles = {}
    for i in order:
        y = x + i
        handles[("allreduce", i)] = (hvd.allreduce_async(
            y, name=f"{tag}.ar.{i}", op=hvd.Sum), y)
        handles[("allreduce_average", i)] = (hvd.allreduce_async(
            y, name=f"{tag}.av.{i}"), y)
        handles[("allgather", i)] = (hvd.allgather_async(
            y, name=f"{tag}.ag.{i}"), y)
        handles[("broadcast", i)] = (hvd.broadcast_async(
            y, 0, name=f"{tag}.bc.{i}"), y)
        handles[("grouped", i)] = (hvd.grouped_allreduce_async(
            [y, y], name=f"{tag}.gr.{i}"), y)
    out = {}
    for key, (h, y) in handles.items():
        got = hvd.synchronize(h)
        out[key] = (got[1] if isinstance(got, list) else got, y)
    return out


def phase_control_plane(smi: str, main: dict) -> dict:
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.benchmark import make_bench_state
    from horovod_tpu_torch.ops import fused_stem, fusion

    dev = torch.device("cuda", 0)
    rt = hvd.basics.runtime()
    check(rt.thread.is_alive() and rt.groups[0].nccl,
          "the control plane's thread or NCCL data group is missing")
    torch.cuda.empty_cache()
    checked = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        base = torch.arange(-6, 6, device=dev).reshape(3, 4).to(dtype)
        for call in range(4):
            order = list(range(4))[::-1 if call % 2 else 1]
            tag = f"p10.{str(dtype)[6:]}.{call}"
            for (kind, i), (got, want) in _submit_all(hvd, base, tag,
                                                      order).items():
                check(got.device == dev and got.dtype == dtype
                      and torch.equal(got, want),
                      f"control plane {kind} {i} {dtype}: {got} != {want}")
                checked += 1
        for name, got in (
                ("reducescatter", hvd.reducescatter(base)),
                ("alltoall", hvd.alltoall(base)),
                ("alltoall splits", hvd.alltoall(base, splits=[3])[0]),
                ("allreduce_", hvd.allreduce_(base.clone(), op=hvd.Sum))):
            check(got.device == dev and got.dtype == dtype
                  and torch.equal(got, base), f"control plane {name} {dtype}")
            checked += 1
        if dtype.is_floating_point:
            check(torch.equal(hvd.allreduce(base, op=hvd.Adasum), base),
                  f"control plane Adasum {dtype}")
            checked += 1
    hvd.barrier()
    check(hvd.join() == 0, "hvd.join() at size 1 is not 0")
    print(f"control plane: {checked} results of every eager op through the "
          f"runtime (f32, bf16, int32; names reversed every other call) "
          f"equal their size-1 results; join() = 0", flush=True)

    # Phase 4's step, every gradient submitted from its autograd hook.
    st = make_bench_state("resnet50", batch_size=BATCH, image_size=IMAGE,
                          stem="s2d_fused", input_dtype="bfloat16")
    model, opt = st.model, st.optimizer
    params = [p for p in model.parameters() if p.requires_grad]
    index = {id(p): i for i, p in enumerate(params)}
    handles = {}

    def hook(p):
        i = index[id(p)]
        handles[i] = hvd.allreduce_async(p.grad, name=f"grad.{i}",
                                         op=hvd.Average)

    hooks = [p.register_post_accumulate_grad_hook(hook) for p in params]

    def step():
        model.train()
        loss = F.cross_entropy(model(st.images), st.labels)
        loss.backward()
        check(len(handles) == len(params),
              f"{len(handles)} of {len(params)} gradients submitted")
        for i, h in handles.items():
            params[i].grad = hvd.synchronize(h)
        handles.clear()
        opt.step()
        opt.zero_grad()
        return loss.detach()

    fused_stem.launches.reset()
    losses = [step() for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    fusion.allreduce_calls.reset()
    cycles0, seconds0 = rt.cycles, rt.cycle_seconds
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    losses += [step() for _ in range(TIMED_STEPS)]
    t1.record()
    torch.cuda.synchronize()
    cycles = rt.cycles - cycles0
    seconds = rt.cycle_seconds - seconds0
    fused = fusion.allreduce_calls.count
    launches = fused_stem.launches.count
    for h in hooks:
        h.remove()
    steps = WARMUP_STEPS + TIMED_STEPS
    losses = [float(x) for x in losses]
    for i, loss in enumerate(losses):
        check(loss == loss and abs(loss) != float("inf"),
              f"phase 10 step {i} loss is not finite: {loss}")
    check(launches == steps, f"fused_stem launched {launches} times in "
          f"phase 10's {steps} forward passes")
    timed = losses[WARMUP_STEPS:]
    check(timed == main["step_losses"],
          f"phase 10 timed losses {timed} differ from phase 4's "
          f"{main['step_losses']}")
    check(fused >= TIMED_STEPS, f"{fused} fused all-reduces in "
          f"{TIMED_STEPS} steps")
    ms = t0.elapsed_time(t1) / TIMED_STEPS
    result = {"ms_per_step": ms, "phase4_ms_per_step": main["ms_per_step"],
              "gradients": len(params), "cycles_per_step": cycles /
              TIMED_STEPS, "fused_allreduces_per_step": fused / TIMED_STEPS,
              "ms_per_cycle": seconds / max(cycles, 1) * 1e3,
              "fused_stem_launches": launches, "nvidia_smi": smi}
    print(f"control plane ResNet-50 s2d_fused, batch {BATCH}: {ms:.2f} "
          f"ms/step (phase 4: {main['ms_per_step']:.2f} ms/step) on {smi}; "
          f"{len(params)} gradients a step as named allreduce_async; "
          f"{result['cycles_per_step']:.2f} cycles/step, "
          f"{result['fused_allreduces_per_step']:.2f} fused all-reduces/"
          f"step, {result['ms_per_cycle']:.3f} ms/cycle; fused_stem "
          f"launches {launches} = forward passes {steps}; the "
          f"{TIMED_STEPS} timed losses {timed[0]:.6f} -> {timed[-1]:.6f} "
          f"equal phase 4's bit for bit", flush=True)
    print("control plane: " + json.dumps(result), flush=True)
    del st, model, opt
    torch.cuda.empty_cache()
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import horovod_tpu_torch as hvd

    smi = phase_card()
    phase_build()
    stem_row = phase_kernel_check()
    stem_row["launches"], _, main_summary = phase_main_path(smi)
    phase_reference()
    flash_rows = phase_flash_check()
    counts = phase_lm_main_path(smi)
    phase_lm_reference()
    phase_hvd_api(smi, main_summary)
    phase_control_plane(smi, main_summary)
    for row, count in zip(flash_rows, counts.values()):
        row["launches"] = count
    hvd.shutdown()
    print(smi, flush=True)
    print(json.dumps({"kernels": [stem_row] + flash_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
