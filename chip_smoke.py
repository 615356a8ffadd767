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
   against their plain PyTorch versions, row by row, in bf16 at the LM's
   shape and at small ones (non-causal, a custom scale, segment ids with a
   fully masked row, ragged T, tiles half empty or cut by T or by segment
   borders, every head dim), then every other instance: f16 and f32 at
   the LM's shape [4, 2048, 24, 128], bf16, f16 and f32 at [4, 2048, 12,
   256] and at [4, 2048, 6, 512] (the wide instances), and in each dtype
   small cases at D 256, 512 and 768 and at the padded 80, 96 and 320
   (non-causal with a fully masked row, segments, ragged T, tiles cut by
   T), f32 within FLASH_F32_ROW_*; the autograd Function's output and
   gradients against the plain versions in every dtype; a copy of the
   bf16 wide forward built with a planted fault (a dropped head-dim chunk
   of S on the late q tiles) that the row check must fail; and each
   instance's time beside its bound (f32 at the three-pass TF32 rate),
   its plain version's and ``scaled_dot_product_attention``'s in the same
   dtype, with the backend PyTorch picked for it;
7. LM main path: the transformer-LM benchmark of record (``bench.py``'s
   d3072/L10/H24, T 2048, batch 4, flash attention, bf16 momentum) for 2
   warmup and 10 timed steps, with the flash launch counts read around it;
   (b) the same LM at f32 with flash (the f32 kernels, TF32 off) through
   ``make_train_step`` at batch 4, 1 warm-up and 2 timed steps: tok/s,
   the f32 launches (10 of each a step) and the first loss against the
   same forward through the local route at relative 1e-5; (c) its width
   with 12 heads of 256 (bf16, flash) for 2 warm-up and 3 timed steps:
   tok/s beside phase 7's and the head-dim-256 launches; (d) the same
   with 6 heads of 512 (the wide bf16 instances): tok/s, peak memory and
   the head-dim-512 launches;
8. LM reference: a small f32 LM step on the GPU against the CPU and
   through the flash route against the local one, and small packed LMs
   (bf16 and f16 at head dims 128 and 256, f32 at 256, f16 and f32 at
   512) whose logits and gradients go through the flash route against the
   local one;
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
   cycle printed beside phase 4's ms/step;
11. sequence and tensor parallelism on the card: (a) ring-flash, ring
   and Ulysses attention (flash kernel) at 4 virtual ranks (threads of
   this process, every exchange a swap in memory: NCCL refuses two
   ranks on one card) at B 4, T_global 8192, H 24, D 128 bf16, causal,
   causal packed and non-causal packed, forward and backward, held row
   by row to ``flash_attention`` over the whole sequence with phase 6's
   limits, the flash launches checked per ring step and each variant's
   ms printed beside the whole-sequence kernel's; (b) the LM of record
   through the dp x tp x sp step on a 1x1x1 NCCL mesh with ring-flash
   and with Ulysses attention, its losses held to phase 7's and its
   tok/s printed beside them; (c) with 2 or more cards, two steps of a
   small LM on a 1x1x2 or 1x2x2 NCCL mesh against gloo on the CPU, else
   one line saying why it did not run;
12. decode, remat and pipeline parallelism: (a) the decode benchmark at
   the reference's defaults (d2048/L8/H16, vocab 32768, B 8, prompt 16,
   total 512, bf16) beside its byte bound, then at the LM of record's
   width (bf16, a cache of 2048) ``decode_step``'s logits at each of 256
   positions held row by row to ``forward`` with flash and with local
   attention, and ``generate`` held to a step-by-step argmax; (b) phase
   7's step under ``remat="dots"`` and ``"full"``, its losses held to
   phase 7's and the flash launches to the policy's count (2/1/1 a layer
   and step); (c) the LM of record on a 1x2 (data, pipe) mesh of 2
   virtual ranks under GPipe, 1F1B, interleaved and interleaved 1F1B
   (virtual 5), three steps each, held to the plain local-attention step
   on the same batch and weights, with ms/step and peak memory; (d) with
   2 or more cards, two dp x pp steps of every schedule of a small LM
   over NCCL against gloo on the CPU, else one line saying why it did not
   run;
13. ZeRO-1 and the wire codecs: (a) the LM of record through
   ``make_train_step(shard_optimizer=True)`` on the NCCL group of size 1
   under ``none``, ``bf16``, ``int8`` and ``powersgd:4``, 2 warmup and 12
   timed steps each: ``none``'s losses equal to phase 7's bit for bit,
   every codec's within the reference's bound of ``none``'s, the
   reduce-scatters, all-gathers and all-to-alls a step and the logical
   wire bytes a step as the bucket plan reckons them (int8 0.25 of
   ``none``'s, bf16 0.5), the flash launches, ms/step, tok/s, peak
   memory and optimizer-state bytes beside phase 7's; (b) with 2 or more
   cards, two ZeRO steps of a small LM under ``none`` and ``int8`` over
   NCCL against gloo on the CPU, and the two-level reduce-scatter and
   ``cross_level_psum`` on a (dcn, ici) mesh against the flat
   collectives, else one line saying why it did not run.

14. expert parallelism, the resilience ladder and checkpoints: (a) at 4
   virtual ranks, one expert a rank (the LM of record's MLP, d 3072, d_ff
   12288, f32 params, bf16 compute), 8192 tokens a rank, ``moe_layer``
   top-1 (capacity factor 1.25) and top-2 (2.5) and ``moe_layer_ragged``
   (1.25), forward and backward, held row by row to a one-process
   oracle with no exchange and, at a small width, to the same call on
   CPU threads, with ms per call, the tokens that reached no expert and
   the peak memory (the router skewed so that expert 0 overflows); (b)
   phase 7's model and batch under
   ``StepGuard(policy="rollback", snapshot_interval=1)`` for 8 steps,
   clean and with a NaN gradient at step 5 (a hook on the embedding's
   gradient): the rollback to step 4, the parameters and momentum equal
   to the snapshot bit for bit, the following losses equal to the clean
   run's from step 4 bit for bit, ms/step with the guard and the time
   of a stage; (c) in the clean run a ``save_async`` overlapping two
   steps and a ``save`` at step 4, restored into a fresh model and
   optimizer whose next three losses equal the clean run's bit for bit,
   with the bytes and the seconds; (d) a small LM on the card preempted
   at step 3 in a subprocess (exit 75, a checkpoint), resumed in a
   second to the final loss of an uninterrupted third bit for bit; (e)
   with 2 or more cards, ``alltoall_ragged`` (with drops),
   ``moe_layer_ragged`` and a reducescatter whose shape is bad on one
   rank over NCCL against gloo on the CPU, else one line saying why it
   did not run.
15. elastic continuity and warm restart, this script acting as the
   launcher (it sets ``HOROVOD_SPILL_DIR`` and
   ``HOROVOD_RESTART_ATTEMPT`` for subprocesses): (a) phase 7's model,
   batch and seeds under ``StepGuard(rollback)`` spilling every third
   commit, a disk checkpoint at step 1, SIGKILLed right after the
   unspilled commit of step 3; attempt 1 starts from another seed,
   ``warm_restore`` must report ``source == "spill"`` at step 2 with the
   spilled cursor, and every loss of both attempts equals phase 7's at
   its step bit for bit; the spill's bytes, its seconds by part (host
   copy, serialization, crc, write, fsync), ms/step with and without a
   spill and ``warm_restore``'s seconds by part; (b) phase 14 (d)'s small
   LM whose every spill in attempt 0 is torn by
   ``kind=spill_corrupt,attempt=0``: attempt 1 (same spec) rejects the
   spill, restores the disk checkpoint, fires no fault, and its final
   loss equals an uninterrupted run's bit for bit.  The spill and
   checkpoint files are deleted when the phase ends.
16. the control plane's own instruments, each in a process of its own
   (``--control-worker``) so that the knobs are read at ``init``: (a)
   phase 10's step from a fresh state for 36 steps under
   ``HOROVOD_TIMELINE`` with cycle markers: every loss equal to phase
   4's (steps 4-13) bit for bit, the file parsed, each of the 161
   gradients with ``NEGOTIATE_ALLREDUCE``, ``ALLREDUCE`` and an
   ``NCCL_ALLREDUCE`` activity longer than 0 on the card's clock in
   every step, ``CYCLE_START`` present, ms/step beside phase 10's and
   the file's bytes; (b) the same 36 steps under ``HOROVOD_AUTOTUNE``,
   and on (72 at most) until three steps ran after the pin, its
   schedule sized from (a)'s busy cycles a step (the default
   configuration through step 13, then 8 trials): every loss equal to
   (a)'s bit for bit, a log of 5 rows or more that varies a parameter
   and ends pinned, ``sync_tuned_config()`` equal to the pinned
   threshold and the bucketer's, a next step whose bucketed mean takes
   the agreed threshold's bucket count, ms/step before the search and
   after the pin; (c) with 2 or more cards, the eager-op deadline over
   NCCL (rank 1 never submits a name; rank 0 gets ``EagerStallError``
   naming it and the other ranks within the deadline plus 2 s), then
   process sets inside a rank-subset job over NCCL, else one line
   saying why it did not run.
17. telemetry and the schedule verifier: (a) in one worker process
   (``--telemetry-worker``), phase 10's step from a fresh state for
   phase 10's 13 steps under each of three ``init``s: telemetry unset
   (the snapshot stays empty, no span); ``HOROVOD_METRICS``,
   ``HOROVOD_TRACE`` and ``HOROVOD_EAGER_TIMELINE`` (``hvd_eager_ops_total``
   equal to ``runtime.requests``, ``hvd_fusion_buckets_total`` to
   ``fusion.allreduce_calls``, ``hvd_collective_bytes_total`` to the
   gradients' bytes a step); ``HOROVOD_SCHEDULE_CHECK`` (a record per
   request, 0 divergences); every loss equal across the modes and to
   phase 10's bit for bit, ms/step beside phase 10's, series, spans,
   timeline bytes and records a step; (b) the LM of record through the
   ZeRO-1 ``int8`` step for 3 steps with metrics on: compression bytes
   out over in equal to phase 13's wire ratio, ``hvd_zero_*`` to the
   plan's buckets.  The tree needs 4 cards: ``-k tree`` of
   ``tests/test_torch_cuda_collective.py``.

18. the reference's other headline models, ResNet remat, synchronized
   BatchNorm and the two benchmark lanes: (a) Inception-v3's average
   pool on the card, forward and backward, channels-last and NCHW, f32
   and f64, against the CPU's f64 (``avg_pool_check``); then phase 5's
   comparison for
   VGG-11 (GAP and classic head) at 32x32, batch 4, and Inception-v3 at
   139x139, batch 16, one train step on the card and in the CPU port at
   f64 and f32: the f64 steps within phase 5's limits, the card's f32
   step within them of the f64 step (Inception-v3's, whose stem kernels
   are ill conditioned, within twice the CPU's f32 step's distance,
   with and without cuDNN), the f32 eval logits within the state limit;
   (b) VGG-16
   and Inception-v3 at the reference harness's defaults (batch 64,
   224x224, 1000 classes, bf16 input) and ResNet-101
   at ``bench.py``'s batch 128 (conv7 stem), 3 warmup and 10 timed steps
   each: img/s, ms/step, MFU and peak memory, finite losses, and a
   ``run_profile`` breakdown of VGG-16 and Inception-v3 (through
   ``utils.profiling``), with VGG-16's top five layers from ``by_layer``
   on a trace with module scopes, where at most ZOO_OTHER_SHARE of the
   kernel time may reach no layer and ZOO_UNTRACKED_SHARE have a launch
   it cannot find; (c) phase 4's
   step under ``remat="lean"`` and ``"full"`` (and ``None`` again, for
   its final statistics): losses equal to phase 4's and final running
   statistics to ``None``'s bit for bit, one fused-stem launch a step,
   ms/step and peak memory; (d) phase 4's step with BatchNorm
   synchronized over the NCCL group of size 1, alone and under each
   ``remat``: losses bitwise phase 4's, 53 statistics all-reduces a step
   (none in a recompute); (e) ``run_step_guard_benchmark``
   on phase 4's step, the overhead printed, not gated; (f) with 2 or
   more cards, ``run_scaling_efficiency`` for ResNet-50 and two
   synchronized-BN steps of a small ResNet over NCCL against gloo on the
   CPU, else one line saying why it did not run.
19. the serving plane on the card: (a) ``ToyModel`` on the card against
   the decode contract in plain Python on seeded ``(token, position)``
   batches, with integer and non-integer weights, and the ms of one
   batched ``decode_step`` of 8 sequences beside ``device="cpu"``
   (printed, not gated); (b) ``broadcast_weights`` over the NCCL group
   of size 1 (the generation and the weights unchanged, on the card),
   then a ``Router`` over two in-process replicas on the card streaming
   two tenants with ``push_weights`` mid-stream: every stream flips
   generation at its pause point, none dropped; (c) two replicas behind
   ``ReplicaWorker.attach`` on 127.0.0.1: ``ping``, ``stats``,
   ``decode`` and ``update_weights`` through ``RpcReplicaHandle``, a
   wrong key refused, a ``replica_crash`` rule (``HOROVOD_FAULT_SPEC``
   set in this process, restored after) failed over with the streams of
   a clean run and nothing dropped, a ``request_storm`` burst under the
   ``storm`` tenant; (d) ``load_replica_model`` from a checkpoint the
   phase saves (generation = step; the files deleted); (e)
   ``run_serving_benchmark`` on the card, its rows equal to the CPU's.
20. the port's own launcher (``python -m horovod_tpu_torch.runner``), which
   needs no JAX: (a) ``-np 1 --metrics-file`` around ``python -m
   horovod_tpu_torch.benchmark`` with phase 4's model, batch, stem and
   input dtype (LAUNCH_WARMUP warm-up and LAUNCH_ITERS timed steps): rc 0,
   the rank's result on the card, its fused-stem launches read from the
   rank's ``hvd_kernel_launches`` series in the merged metrics file (one
   a forward pass), img/s printed beside phase 4's (not gated); (b)
   ``--check-build`` lists NCCL; (c) ``-np 4`` on gloo, CPU tensors asked
   for by name, the ranks split into 2 hosts of 2 (``HOROVOD_LOCAL_*``
   set before ``init``, as ``tests/distributed/hier_check_np4.py`` does):
   the eager allreduce and allgather at sizes 1, 7, 100,003 and 1,000,003
   on integer-valued f32 data, flat and then through the two-level plane
   after a re-init, bit for bit equal, ``hierarchical_enabled()`` true,
   the cross bytes summed over the ranks half the flat bytes; (c) runs
   on the CPU while (a) and (b) run, so (a)'s img/s may read a little
   low beside phase 4's.  The NCCL
   form of (c) needs 4 cards: ``-k hier`` of
   ``tests/test_torch_cuda_collective.py``.
21. the fleet controller (``python -m horovod_tpu_torch.runner fleet -H
   localhost:1``) on the one card: (a) ``low`` (priority 0) trains phase
   4's ResNet-50 ``s2d_fused`` step (batch 256, bf16) for phase 4's 13
   steps; on its first attempt it waits at step FLEET_LOW_HOLD for its
   preemption.  ``high`` (priority 10, submitted FLEET_HIGH_AFTER s in)
   runs the LM of record of phase 7 for 1 warm-up and 1 timed step.
   ``high`` starves past the deadline, ``low`` is preempted (SIGTERM,
   coordinated save, rc 75, no host blamed), ``high`` runs to rc 0, and
   ``low`` is re-admitted and resumes at its saved step; its losses from
   step 3 on equal phase 4's bit for bit.  The fleet's summary counts 3
   admissions and 1 preemption; every attempt ran on the card; the
   fused-stem launches of ``low``'s two attempts and the flash launches
   of ``high`` come from each attempt's metrics file.  (b) on the CPU
   beside (a): a 2-rank gloo job of the launcher with
   ``--elastic-restarts 1`` under ``site=allreduce,kind=crash,after=3,
   attempt=0`` resumes from its checkpoint and ends at the state of the
   same job run without the fault, bit for bit.

The flash rows' launches add the paths of phases 7, 11 (a), 11 (b), 12
(b), 13 (a), 14 (b, c), 15, 17 (b) and, for the forward kernel, 12 (a);
the rows of the other instances (f16 and f32 at head dim 128, bf16, f16
and f32 at 256 and at 512) count phases 7 (b), 7 (c), 7 (d) and 8;
the fused stem's add phase 16's 73 or more (36 under the timeline, 36
to 72 under the tuner, 1 bucketed step), phase 17's 39 and phase 18's
104 forward passes ((c) 3 x 13, (d) 3 x 13, (e) 2 x 13), phase 20
(a)'s and phase 21 (a)'s 13 to phase 4's; the flash rows add phase 21
(a)'s 20 each.
It prints one JSON line of kernel numbers and, last, one JSON line
naming the device.  With no GPU
it exits non-zero and prints no result.

Other modes: ``--avg-pool-check`` prints phase 18 (a)'s average-pool
check ungated; ``--inception-readings`` prints Inception-v3's f32 step
distances that set phase 18 (a)'s limits; ``--flash-f32-readings`` the
f32 flash kernels' worst rows and their distances from f64 that set
FLASH_F32_ROW_ATOL; ``--ptxas`` each kernel instance's registers, stack,
spills and how many spill instructions sit in a loop
(``_build.ptxas_report``).
"""

from __future__ import annotations

import functools
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
# Phase 7 (b): the LM of record in f32 (the f32 flash kernels, TF32 off)
# through make_train_step at phase 7's batch, (warm-up, timed) steps; its
# first loss held to the same forward through the local route.
LM_F32_STEPS = (1, 2)
LM_F32_LOSS_RTOL = 1e-5
# Phase 7 (c): the LM of record's width with 12 heads of 256 (bf16, flash;
# Gemma-7B's attention is 16 heads of 256 at d_model 3072).
LM_WIDE = dict(LM, n_heads=12)
LM_WIDE_STEPS = (2, 3)
# Phase 7 (d): the same width with 6 heads of 512 (bf16, flash), as many
# steps.  No configuration of record has heads this wide: it runs the
# wide instances (head dims above 256) at full width.
LM_WIDE512 = dict(LM, n_heads=6)
# First and last timed LM loss with the earlier wmma forward and dK/dV
# kernels (same seeds), printed beside this run's for the record: the
# summation order differs, so they are not expected bit for bit.
LM_WMMA_LOSSES = (10.997063, 10.953733)
# Card roofline (NVIDIA H100 SXM data sheet): HBM bytes/s, float32
# non-tensor-core operations/s and dense bf16 tensor-core operations/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# The f32 flash rows' rate: f32-accurate products on the tensor cores as
# three TF32 passes (dense TF32 495e12 / 3), the least time the card takes
# for them (flash_attention_f32.cu's three kernels run so).
TF32X3_OPS_PER_S = 495e12 / 3
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
# f16 operands are held to bf16's limits.  f32 operands (the kernels of
# flash_attention_f32.cu, the plain versions with TF32 off): the same
# row form 1024x tighter in its relative term, far above f32 summation
# noise over T 2048 (about 3e-6 of a row).  Its floor is 256x tighter: dq
# of a causal row's first query is 0 in exact arithmetic (its one key
# gives dS = dO.v0 - dO.o0 = 0), and both versions leave f32 cancellation
# noise there, 3.9e-6 (kernel) and 4.6e-6 (plain) from an f64 reference at
# [96, 2048, 128] (``--flash-f32-readings`` on the H100); against a floor
# of 2^-18 the kernel's row 0 read 1.75x its limit, against 2^-16 0.44x.
# The tensor-core forward and dK/dV (three TF32 passes) read at most 0.27x
# there and at [48, 2048, 256], as far from f64 as the plain versions.
FLASH_F32_ROW_RTOL = 2 ** -16
FLASH_F32_ROW_ATOL = 2 ** -16
# Phase 6's instances beyond bf16 at the LM's head dim, each at the shape
# of the path that runs it: (dtype, heads, head dim) at B 4, T 2048.
FLASH_INSTANCES = ((torch.float16, 24, 128), (torch.float32, 24, 128),
                   (torch.bfloat16, 12, 256), (torch.float16, 12, 256),
                   (torch.float32, 12, 256), (torch.bfloat16, 6, 512),
                   (torch.float16, 6, 512), (torch.float32, 6, 512))
# Phase 6's planted fault in a copy of flash_attention.cu: the bf16 wide
# forward drops the last head-dim chunk of S on the q tiles from 1024 on
# (text in the source, its faulty replacement); held at [2, 2048, 2,
# 512], the row check must fail it.
PLANTED_WIDE_FAULT = (
    "      mma_chunk<FWD_BR, WF_BC, E>(sc, sQ, wg * 64, sQ + WF_Q, c);\n",
    "      if (c + 1 < nc || q0 < 1024)\n"
    "        mma_chunk<FWD_BR, WF_BC, E>(sc, sQ, wg * 64, sQ + WF_Q, c);\n")
# The flash route in a small bf16 LM against the local route: logits row
# by row (one row per token), ||a_r - b_r|| / ||b_r||, and loss_fn's
# gradients leaf by leaf, ||a - b|| / ||b||.  The local route rounds its
# scores and probabilities to bf16, so it is the noisier of the two.
LM_LOGIT_TOL = 2 ** -5
LM_GRAD_TOL = 2 ** -4
# Phase 8's small packed LMs, flash against local on the card: (dtype,
# d_model) at 2 heads (head dims 128, 256 and 512).  f32 is held to
# LM_F32_FLASH_TOL: both routes compute in f32 (TF32 off) and differ only
# in the order of their sums.
SMALL_FLASH_LMS = ((torch.bfloat16, 256), (torch.bfloat16, 512),
                   (torch.float16, 256), (torch.float16, 512),
                   (torch.float32, 512), (torch.float16, 1024),
                   (torch.float32, 1024))
LM_F32_FLASH_TOL = 1e-4
# Phase 11 (a): ring-flash, ring and Ulysses attention at 4 virtual ranks
# (threads of this process on the one card) at the LM of record's width:
# (B, T_global, H, D, ranks); T_local 2048, bf16.  Packed segments over
# the global sequence cross the shard borders 0|1|2 and 2|3, and one
# (positions 4600-5599) lies wholly inside shard 2.  Cases: (causal,
# packed); the non-causal packed case gives ring steps whose every row is
# masked.  Held with phase 6's limits.
SP_SHAPE = (4, 8192, 24, 128, 4)
SP_SEGMENTS = (1500, 3100, 1000, 2592)
# (variant, operand dtype, held to phase 6's limits).  The plain ring
# route computes scores, probabilities and its online state in its
# operands' dtype, as the reference does, and its bf16 backward runs
# through autograd in bf16, where dS = P * (dP - di) cancels: a CPU
# rehearsal at H 2 read dq at 3.8x and dk at 10x the kernels' row limit.
# So it is held on f32 copies of the same bf16 values, against the flash
# function's plain version over the whole sequence in f32 (the bf16
# kernels' backward takes di from their bf16 o, which moves dq on rows
# that attend to one key: see _flash_grad_case), and its bf16 run is
# printed beside them (checked finite only).
SP_VARIANTS = (("ring_flash", torch.bfloat16, True),
               ("ring", torch.float32, True),
               ("ring", torch.bfloat16, False),
               ("ulysses", torch.bfloat16, True))
SP_CASES = ((True, False), (True, True), (False, True))
SP_TIMED_RUNS = 3
# Phase 11 (b): the LM of record through the dp x tp x sp step on a 1x1x1
# mesh.  Ring-flash at ring size 1 runs only the diagonal step, phase 7's
# kernel, but rounds o once more (acc = o*l, then /l); Ulysses at size 1
# is phase 7's flash call.  Each timed loss within this relative
# difference of phase 7's.
LM_SP_LOSS_RTOL = 1e-3
# Phase 11 (c) and tests/test_torch_cuda_collective.py: two steps of a
# small bf16 LM (head_dim 64, T 512, ring-flash) on NCCL ranks against the
# same on gloo ranks on the CPU: losses within SP_STEP_LOSS_RTOL
# (relative), each leaf's update within SP_STEP_UPDATE_TOL of the gloo
# update's norm (bf16 compute rounds differently on the card).
SP_STEP_LM = dict(vocab_size=512, d_model=256, n_heads=4, n_layers=2,
                  d_ff=512, max_seq=512)
SP_STEP_BATCH = 2
SP_STEP_LOSS_RTOL = 2e-2
SP_STEP_UPDATE_TOL = 5e-2
# Phase 12 (a): the decode benchmark at the reference's defaults
# (horovod_tpu/benchmark.py:595), bf16; its byte bound counts each bf16
# matmul weight (layers and tied head) and the whole static K/V cache
# read once a step, the logits written once.
DECODE_BENCH = dict(d_model=2048, n_layers=8, n_heads=16, vocab_size=32768,
                    batch_size=8, prompt_len=16, total_len=512, num_iters=3)
# The decode==forward oracle at the LM of record's width: a cache of
# DECODE_MAX_LEN positions, the first DECODE_POSITIONS of DECODE_BATCH
# sequences, each decode step's logits held row by row (||a_r - b_r|| /
# ||b_r||) to the forward's at that position, flash and local.  The
# decode's attention is f32 over the cache, the flash kernel's f32 with a
# bf16 P, the local route's bf16; the residual stream is rounded to bf16
# after every sublayer, 20 times over 10 layers.  On the H100 this phase
# reads 0.0118 at the worst row against either route: the limit is about
# 2.7x that, and a decode that dropped a layer or a head reads O(1).
DECODE_MAX_LEN = 2048
DECODE_POSITIONS = 256
DECODE_BATCH = 2
DECODE_LOGIT_TOL = 2 ** -5
# generate against a step-by-step argmax of decode_step: prompt, total.
DECODE_GENERATE = (16, 64)
# Phase 12 (b): remat recomputes each layer's forward in the backward, the
# flash forward kernel with it: per step and layer 2 forward launches
# under "dots" and "full" (1 under "none"), 1 dQ and 1 dK/dV.  The same
# operations on the same inputs: the losses are expected equal to phase
# 7's bit for bit, and held within LM_SP_LOSS_RTOL.
REMAT_FWD_PER_LAYER = {"none": 1, "dots": 2, "full": 2}
# Phase 12 (c): the LM of record on a 1 x 2 (data x pipe) mesh of 2
# virtual ranks, M microbatches, PP_STEPS steps of each schedule (the
# interleaved ones with PP_VIRTUAL chunks a rank, one layer each), held to
# the plain local-attention step on the same batch and weights: each loss
# within LM_PP_LOSS_RTOL (relative) of the plain step's and of GPipe's,
# and each leaf's update after PP_STEPS steps within LM_PP_UPDATE_TOL of
# the plain step's (||du - du_plain|| / ||du_plain||).  The microbatched
# [1, T, D] matmuls round differently in bf16 from the [4, T, D] ones; on
# the H100 this phase reads losses 2.3e-5 apart and a worst leaf (an
# RMSNorm scale) at 0.114; a gradient scaled by P = 2 reads 1.0.
PP_MICROBATCHES = 4
PP_STEPS = 3
PP_VIRTUAL = 5
LM_PP_LOSS_RTOL = 1e-3
LM_PP_UPDATE_TOL = 0.25
# Phase 12 (d) and tests/test_torch_cuda_collective.py: two steps of every
# schedule of a small bf16 pipelined LM (4 layers, 2 microbatches, the
# interleaved schedules with 2 chunks a rank) on NCCL ranks against gloo
# ranks on the CPU, held as phase 11 (c).
PP_STEP_LM = dict(SP_STEP_LM, n_layers=4)
PP_STEP_BATCH = 2
PP_STEP_MICROBATCHES = 2
PP_STEP_VIRTUAL = 2
# Phase 13 (a): the LM of record through make_train_step(
# shard_optimizer=True) on the card's one-rank NCCL group under each wire
# codec, phase 7's warmup and ZERO_TIMED_STEPS timed steps.  At one rank
# the reduce-scatter and all-gather are copies, the mean a multiply by
# 1.0 and the flat-bucket sgd phase 7's arithmetic: under "none" the
# first LM_TIMED_STEPS timed losses must equal phase 7's bit for bit.
# Every codec's losses within ZERO_LOSS_BOUND (a, b: b + a * |none's|) of
# none's from the third timed step on (the reference's own bound,
# tests/test_compression.py:448-461); int8's logical wire bytes a step
# INT8_WIRE_RATIO (value, tolerance) of none's, bf16's 0.5, powersgd's
# what the plan reckons.
ZERO_CODECS = ("none", "bf16", "int8", "powersgd:4")
ZERO_TIMED_STEPS = 12
ZERO_LOSS_BOUND = (0.05, 1e-3)
INT8_WIRE_RATIO = (0.25, 0.01)
# Phase 13 (b) and tests/test_torch_cuda_collective.py: two ZeRO steps of
# the small bf16 LM of phase 11 (c) under none and int8 on NCCL ranks
# against gloo ranks on the CPU (held as phase 11 (c); int8's leaves with
# room for the codec's own noise: compare_zero_step), and on a 2x2
# ("dcn", "ici") mesh the two-level reduce-scatter and cross_level_psum
# against the flat collectives, on values where every sum is exact.
ZERO_STEP_CODECS = ("none", "int8")
# Phase 14 (a): MoE at the LM of record's FFN width on 4 virtual ranks
# (threads on the one card: NCCL refuses two ranks on one card), one
# expert a rank, the LM's MLP (w1 [3072, 12288], tanh GELU, w2 [12288,
# 3072]; f32 params, bf16 compute), T_local = batch 4 x T 2048 tokens, a
# [3072, 4] router whose column 0 has MOE_ROUTER_SKEW times the others'
# scale, so expert 0 draws more tokens than its capacity and the drop
# path runs at full width: (label, layer, router, capacity factor), the
# defaults of examples/jax_moe.py:68.  Each held row by row (phase 6's
# limit) to a one-process oracle that routes by code of its own (torch's
# softmax, argmax and cumsum) and runs every expert on the tokens with no
# dispatch, buffers or exchange; its gradients leaf by leaf within
# MOE_GRAD_TOL (||a - b|| / ||b||: the experts' bf16 matmuls see other row
# batches); at MOE_SMALL width the card's answers held to the same call on
# CPU threads; and the port's routers on the card held to the CPU's bit
# for bit on rank 0's first MOE_ROUTE_TOKENS tokens at full width.
MOE_RANKS = 4
MOE_VARIANTS = (("moe_layer top1", "dense", "top1", 1.25),
                ("moe_layer top2", "dense", "top2", 2.5),
                ("moe_layer_ragged", "ragged", "top1", 1.25))
MOE_ROUTER_SKEW = 2.0
MOE_SMALL = dict(d=64, h=256, t=256)
MOE_GRAD_TOL = 2 ** -6
MOE_ROUTE_TOKENS = 2048
MOE_TIMED_RUNS = 2
# Phase 14 (e) and tests/test_torch_cuda_collective.py: on NCCL ranks
# against gloo ranks, alltoall_ragged with MOE_A2A_ROWS rows a rank and a
# capacity of MOE_A2A_CAP (bit for bit), and an f32 moe_layer_ragged at
# overflow within MOE_F32_TOL.
MOE_A2A_ROWS, MOE_A2A_CAP = 14, 6
MOE_F32_TOL = 1e-4
# Phase 14 (b), (c): phase 7's model and batch under StepGuard(rollback,
# snapshot_interval=1) for GUARD_STEPS steps: a clean run (a save_async at
# ASYNC_STEP overlapping the next two steps, a save at CKPT_STEP), a run
# with a NaN gradient at GUARD_NAN_STEP (a hook on the embedding's
# gradient: the LM step's mean is fused_pytree_mean, no eager collective,
# so the nan fault kind has no site there; that run's step has no in-step
# guard, so the NaN update lands for the StepGuard to repair), and a
# fresh model restored
# from CKPT_STEP for the steps after it.  Losses bit for bit.
GUARD_STEPS = 8
GUARD_NAN_STEP = 5
CKPT_STEP = 4
ASYNC_STEP = 1
# Phase 14 (d): a small LM on the card (phase 11 (c)'s), preempted at
# PREEMPT_AT of PREEMPT_STEPS steps in a subprocess, resumed in another.
PREEMPT_STEPS = 6
PREEMPT_AT = 3
# Phase 15 (a): phase 7's model, batch and seeds under StepGuard(rollback,
# snapshot_interval=1) with HOROVOD_SPILL_INTERVAL=WARM_SPILL_INTERVAL in
# a subprocess that saves a disk checkpoint at step WARM_DISK_STEP
# (commits 1-4 at steps 0-3: one spill, at step 2) and SIGKILLs itself
# right after committing step WARM_KILL_STEP, which was not spilled; a
# second subprocess from another seed (WARM_SEED) warm-restores and trains
# to WARM_STEPS.  Its losses bit for bit phase 7's at the same steps.
# (One spill, not two: a spill of the LM of record costs about 17 s.)
WARM_SPILL_INTERVAL = 3
WARM_DISK_STEP = 1
WARM_KILL_STEP = 3
WARM_STEPS = 5
WARM_SEED = 7
# Phase 15 (b): phase 14 (d)'s small LM, every spill of attempt 0 torn by
# the spill_corrupt fault (attempt=0), a disk checkpoint at step
# DISK_RUNG_SAVE; attempt 1 (same fault spec) restores from the disk and
# trains to DISK_RUNG_STEPS, its final loss bit for bit an uninterrupted
# run's.
DISK_RUNG_SAVE = 1
DISK_RUNG_KILL = 3
DISK_RUNG_STEPS = 6
DISK_RUNG_FAULT = "rank=0,site=spill,kind=spill_corrupt,attempt=0"

# Phase 16: the control plane's instruments.  Phase 10's step from a fresh
# state for CONTROL_STEPS steps under the timeline, then under the tuner
# (its search pins after CONTROL_TRIALS trials); (c)'s eager-op deadline.
CONTROL_STEPS = 36
# The tuner's search lasts as many steps as the cycle times it tries
# allow busy cycles (a host that runs the plane slower stretches it), so
# (b) steps on past CONTROL_STEPS, up to this many, until it has timed
# three steps after the pin.
CONTROL_STEPS_MAX = 72
CONTROL_TRIALS = 8
DEADLINE_S = 3.0
DEADLINE_JOB_S = 180
# Phase 18: the reference's other headline models at the reference
# harness's defaults (batch 64 a rank, 224x224, 1000 classes; bf16 input
# as bench.py feeds it) and ResNet-101 at bench.py's _r101_bench (batch
# 128, the conv7 stem): (name, batch).  (a) holds small ones, card against
# the CPU, as phase 5 holds its small ResNet (SMALL_ZOO below).
ZOO = (("vgg16", 64), ("inception3", 64), ("resnet101", 128))
ZOO_PROFILED = ("vgg16", "inception3")
ZOO_PROFILE_STEPS = 5
# Its profile also traces module scopes for utils.profiling.by_layer.
# Kernels launched outside every layer's scope (VGG's ReLUs and pools,
# the loss, the gradient all-reduce and the optimizer) may take at most
# ZOO_OTHER_SHARE of that trace's kernel time, and kernels whose launch
# by_layer does not find at most ZOO_UNTRACKED_SHARE.  On the H100 at
# 700 W they took 0.0736 and 0 of 91.5 ms a step; one of the 224x224
# stage's BatchNorms lost to "other" (2.8-11.7 ms a pass) would go past.
ZOO_LAYERED = "vgg16"
ZOO_OTHER_SHARE = 0.10
ZOO_UNTRACKED_SHARE = 0.001
# Phase 5's limits: relative loss, absolute state after one SGD step.
SMALL_LOSS_RTOL = 1e-5
SMALL_STATE_ATOL = 1e-4
# Inception-v3's f32 train step is ill conditioned in its stem's kernels:
# an f64 step whose input moves by f32's unit roundoff lands 0.0125 from
# the unmoved one at 139x139 batch 16, so no f32 step comes within phase
# 5's state limit of the f64 step.  On the H100 (TF32 off) the CPU port's
# f32 step lands 0.023-0.106 from it at the INCEPTION_READINGS shapes but
# the last, and the card's within INCEPTION_F32_RATIO times that, with
# cuDNN or without.  Until the average pool's repair
# (``models/inception._avg_pool_same``; ``--avg-pool-check``) the card's
# step with cuDNN landed 22.0-27.1 times as far: PyTorch's channels-last
# CUDA backward of that pool shifts its windows at the borders, and cuDNN
# keeps activations channels-last where PyTorch's own convolution hands
# back NCHW.  At 75x75 batch 4 (4 samples a channel in the last
# BatchNorms) the CPU's distance is the smallest and the card's without
# cuDNN was 2.87 times it.  ``python3 chip_smoke.py --inception-readings``
# prints the readings.  Phase 18 (a) holds Inception-v3's f32 step at
# 139x139 batch 16, with cuDNN and without, within INCEPTION_F32_RATIO
# times the CPU's f32 step's distance (with cuDNN 50 times before the
# repair).
INCEPTION_F32_RATIO = 2.0
# (batch, image size, seed of the images)
INCEPTION_READINGS = ((16, 139, 3), (16, 139, 4), (16, 139, 5),
                      (32, 107, 3), (8, 203, 3), (16, 75, 3), (4, 75, 3))
# ResNet-50's BatchNorms: the stem's, 3 a bottleneck (16) and 4
# projections; each issues one statistics all-reduce a synchronized step.
RESNET50_BN_LAYERS = 53
REMATS = ("lean", "full")
# Phase 9 runs phase 4's step (same seed, batch and SGD) through
# hvd.DistributedOptimizer, which at size 1 adds no hook and no
# collective, after broadcast_optimizer_state's zero-gradient fill (which
# leaves parameters and momentum as a fresh start has them).  The math is
# the same and cuDNN picks the same algorithms for the same shapes, so
# every timed loss must equal phase 4's bit for bit.


_LAPS = [time.perf_counter()]


def _lap(label: str) -> None:
    """Prints the seconds since the previous lap: the phases' own times,
    and the script's so far."""
    now = time.perf_counter()
    print(f"time: {label} {now - _LAPS[-1]:.1f} s (script "
          f"{now - _LAPS[0]:.1f} s)", flush=True)
    _LAPS.append(now)


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


def _reference_resnet(**kw):
    from horovod_tpu_torch.models.resnet import BasicBlock, ResNet
    return ResNet(stage_sizes=[1, 1], block_cls=BasicBlock, num_classes=5,
                  num_filters=16, stem="s2d_fused", **kw)


def _registered(name, **extra):
    from horovod_tpu_torch.models import get_model
    return functools.partial(get_model, name, num_classes=5, **extra)


def _state_vector(model) -> torch.Tensor:
    return torch.cat([v.detach().double().cpu().reshape(-1)
                      for v in model.state_dict().values()])


# Small models' train steps, card against the CPU port: (label, model,
# input shape, batch, truth, witness).  truth: the CPU step's dtype that
# the card's f32 step is held to within phase 5's limits; at float64 the
# f64 steps card and CPU are held to each other too.  witness: hold the
# f32 state by the CPU's f32 distance instead (Inception-v3, above).
REFERENCE = (("small s2d_fused ResNet", _reference_resnet, (8, 8, 12), 4,
              torch.float32, False),)    # the fused stem takes no f64
SMALL_ZOO = (("VGG-11", _registered("vgg11"), (32, 32, 3), 4,
              torch.float64, False),
             ("VGG-11 classic head", _registered(
                 "vgg11", classic_head=True, image_size=32), (32, 32, 3), 4,
              torch.float64, False),
             ("Inception-v3", _registered("inception3"), (139, 139, 3), 16,
              torch.float64, True))


def _reference_step(build, dtype, dev, group, images, labels):
    """One train step of a small model on ``dev``: its loss, its state
    (parameters and statistics) as one f64 vector, and its eval-mode
    logits before the step."""
    from horovod_tpu_torch.benchmark import make_train_step
    from horovod_tpu_torch.topology import build_mesh

    model = build(dtype=dtype, device=dev,
                  generator=torch.Generator().manual_seed(0))
    model.eval()
    with torch.no_grad():
        eval_logits = model(images.to(dev)).double().cpu()
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    loss = make_train_step(model, opt, build_mesh(group, dev))(
        images.to(dev), labels.to(dev))
    return float(loss), _state_vector(model), eval_logits


def _apart(run, truth) -> tuple:
    """(relative loss, absolute state) between two steps."""
    return (abs(run[0] - truth[0]) / max(1.0, abs(truth[0])),
            (run[1] - truth[1]).abs().max().item())


def inception_readings(shapes=INCEPTION_READINGS) -> None:
    """The readings INCEPTION_F32_RATIO was set from: Inception-v3's f32
    train step on the CPU and on the card with and without cuDNN, and an
    f64 step on an input moved by f32's unit roundoff, each against the
    CPU's f64 step (``_apart``'s larger number), at each of ``shapes``
    (TF32 off in every case)."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd

    hvd.init()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gloo = dist.new_group(backend="gloo")
    build = _registered("inception3")
    for batch, size, seed in shapes:
        rng = torch.Generator().manual_seed(seed)
        images = torch.randn(batch, size, size, 3, generator=rng)
        labels = torch.randint(0, 5, (batch,), generator=rng)
        moved = images.double() * (1 + 2.0 ** -24 * torch.randn(
            images.shape, generator=rng, dtype=torch.float64))

        def run(dtype, dev, x=images):
            return _reference_step(build, dtype, dev,
                                   gloo if dev == "cpu" else None, x, labels)

        truth = run(torch.float64, "cpu")
        cpu = max(_apart(run(torch.float32, "cpu"), truth))
        card = max(_apart(run(torch.float32, "cuda"), truth))
        with torch.backends.cudnn.flags(enabled=False):
            plain = max(_apart(run(torch.float32, "cuda"), truth))
        rounding = max(_apart(run(torch.float64, "cpu", moved), truth))
        print(f"Inception-v3 {size}x{size} batch {batch} seed {seed}, from "
              f"the CPU's f64 step: CPU f32 {cpu:.4g}; card f32 "
              f"{card:.4g} ({card / cpu:.3g} x); card f32 without cuDNN "
              f"{plain:.4g} ({plain / cpu:.3g} x); f64 on the input moved "
              f"by f32's unit roundoff {rounding:.4g}", flush=True)
    dist.destroy_process_group(gloo)
    hvd.shutdown()


# Inception-v3's average-pool maps at 139x139 batch 16, a 4x4 one and
# the 1x1 maps of its last blocks at 75x75.
AVG_POOL_SHAPES = ((16, 288, 15, 15), (16, 768, 7, 7), (16, 2048, 3, 3),
                   (2, 3, 4, 4), (2, 2048, 1, 1))
AVG_POOL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def avg_pool_check(gate: bool = True) -> dict:
    """Inception-v3's 3x3/s1 "SAME" average pool on the card, forward and
    backward, channels-last and NCHW, in f32 and f64, against the CPU's
    f64: PyTorch's ``F.avg_pool2d`` (printed, not gated) and the port's
    ``models/inception._avg_pool_same`` (held within AVG_POOL_TOL).
    Returns the largest errors by route, layout, dtype and pass."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models.inception import _avg_pool_same

    routes = {"F.avg_pool2d": lambda x: F.avg_pool2d(
        x, 3, 1, 1, count_include_pad=True), "port": _avg_pool_same}
    worst = {}
    for shape in AVG_POOL_SHAPES:
        g = torch.Generator().manual_seed(7)
        x64 = torch.randn(shape, generator=g, dtype=torch.float64)
        gy64 = torch.randn(shape, generator=g, dtype=torch.float64)
        xt = x64.clone().requires_grad_(True)
        yt = F.avg_pool2d(xt, 3, 1, 1, count_include_pad=True)
        gt, = torch.autograd.grad(yt, xt, gy64)
        for route, pool in routes.items():
            for layout, fmt in (("channels_last", torch.channels_last),
                                ("NCHW", torch.contiguous_format)):
                for dtype in AVG_POOL_TOL:
                    x = x64.to(dtype).cuda().contiguous(
                        memory_format=fmt).requires_grad_(True)
                    y = pool(x)
                    gx, = torch.autograd.grad(y, x, gy64.to(dtype).cuda())
                    for name, got, want in (("fwd", y, yt), ("bwd", gx, gt)):
                        key = (route, layout, str(dtype)[6:], name)
                        err = (got.detach().double().cpu()
                               - want.detach()).abs().max().item()
                        worst[key] = max(worst.get(key, 0.0), err)
    x = torch.arange(16, dtype=torch.float32).reshape(1, 1, 4, 4).cuda()
    rows = {}
    for layout, fmt in (("channels_last", torch.channels_last),
                        ("NCHW", torch.contiguous_format)):
        xx = x.expand(1, 3, 4, 4).contiguous(memory_format=fmt)
        xx.requires_grad_(True)
        y = routes["F.avg_pool2d"](xx)
        gx, = torch.autograd.grad(y.sum(), xx)
        rows[layout] = [round(v * 9, 4) for v in gx[0, 0, 0].tolist()]
    print("F.avg_pool2d on the card: 9 x the gradient of the sum along the "
          "first row of a 4x4 map (the definition gives 4, 6, 6, 4): "
          + json.dumps(rows), flush=True)
    for (route, layout, dtype, name), err in sorted(worst.items()):
        if gate and route == "port":
            check(err <= AVG_POOL_TOL[getattr(torch, dtype)],
                  f"avg pool {route} {layout} {dtype} {name}: {err:.3g} "
                  f"from the CPU's f64")
    print("average pool 3x3/s1 SAME on the card against the CPU's f64, "
          "largest |error| (route, layout, dtype, pass): " + json.dumps(
              {" ".join(k): v for k, v in sorted(worst.items())}),
          flush=True)
    return worst


def phase_reference(cases=REFERENCE, tag="reference") -> None:
    """Small models' train steps on the card against the CPU port, TF32
    off (phase 5 and, with SMALL_ZOO, phase 18 (a))."""
    import torch.distributed as dist

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gloo = dist.new_group(backend="gloo")
    for label, build, shape, batch, truth_dtype, witness in cases:
        rng = torch.Generator().manual_seed(3)
        images = torch.randn((batch,) + shape, generator=rng)
        labels = torch.randint(0, 5, (batch,), generator=rng)
        runs = {(dev, dt): _reference_step(build, dt, dev, grp, images,
                                           labels)
                for dt in dict.fromkeys((truth_dtype, torch.float32))
                for dev, grp in (("cuda", None), ("cpu", gloo))}
        truth = runs["cpu", truth_dtype]
        card = runs["cuda", torch.float32]
        what = f"{tag} {label} {list(shape)} batch {batch}"
        notes = []

        def held(run, name):
            loss, state = _apart(run, truth)
            check(loss <= SMALL_LOSS_RTOL and state <= SMALL_STATE_ATOL,
                  f"{what}: {name} is {loss:.3g} (loss) and {state:.3g} "
                  f"(state) from the CPU's {str(truth_dtype)[6:]} step")
            notes.append(f"{name} loss {loss:.3g} state {state:.3g}")

        if truth_dtype == torch.float64:
            held(runs["cuda", torch.float64], "card f64")
        if not witness:
            held(card, "card f32")
        else:
            cpu = max(_apart(runs["cpu", torch.float32], truth))
            with torch.backends.cudnn.flags(enabled=False):
                plain = _reference_step(build, torch.float32, "cuda", None,
                                        images, labels)
            for name, run, ratio in (
                    ("card f32 without cuDNN", plain, INCEPTION_F32_RATIO),
                    ("card f32", card, INCEPTION_F32_RATIO)):
                d = max(_apart(run, truth))
                check(d <= ratio * cpu, f"{what}: {name} is {d:.3g} from "
                      f"the f64 step, {d / cpu:.3g} times the CPU's f32 "
                      f"step's {cpu:.3g} (bound {ratio})")
                notes.append(f"{name} {d:.3g} ({d / cpu:.3g} x the CPU "
                             f"f32 step's {cpu:.3g})")
        # Eval mode normalizes with the running statistics: nothing
        # amplifies, so the f32 logits agree within the state limit.
        ev = (card[2] - runs["cpu", torch.float32][2]).abs().max().item()
        check(ev <= SMALL_STATE_ATOL, f"{what}: f32 eval logits card vs "
              f"CPU differ by {ev:.3g}")
        print(f"{what}: card f32 loss {card[0]:.6f}, CPU "
              f"{str(truth_dtype)[6:]} {truth[0]:.6f}; from the CPU's "
              f"{str(truth_dtype)[6:]} step: " + "; ".join(notes)
              + f"; f32 eval logits card vs CPU {ev:.3g} (limits: loss "
              f"{SMALL_LOSS_RTOL}, state {SMALL_STATE_ATOL}, TF32 off)",
              flush=True)
    dist.destroy_process_group(gloo)


# ---------------------------------------------------------------------------
# Flash attention and the transformer LM
# ---------------------------------------------------------------------------

def _randn(shape, gen, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _short(dtype) -> str:
    return {torch.bfloat16: "bf16", torch.float16: "f16",
            torch.float32: "f32"}[dtype]


def _row_limits(dtype) -> tuple:
    if dtype == torch.float32:
        return FLASH_F32_ROW_RTOL, FLASH_F32_ROW_ATOL
    return FLASH_ROW_RTOL, FLASH_ROW_ATOL


def _max_abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _rel_to_one(a, b) -> float:
    """max |a - b| / max(1, |b|), elementwise (m is often near 0)."""
    a, b = a.float(), b.float()
    both_inf = (a == b)
    err = ((a - b).abs() / b.abs().clamp_min(1.0)).masked_fill(both_inf, 0.0)
    return err.max().item()


def _row_ratio(a, b, rtol=FLASH_ROW_RTOL, atol=FLASH_ROW_ATOL) -> float:
    """The worst row's ||a_r - b_r|| over its limit rtol * ||b_r|| + atol
    * median_r ||b_r||, rows along the last dimension; the check passes at
    <= 1."""
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    err, ref = (a - b).norm(dim=-1), b.norm(dim=-1)
    limit = rtol * ref + atol * ref.median()
    return torch.where(err == 0, 0.0, err / limit).max().item()


def _segments(b, t, lengths, device="cuda"):
    ids = torch.repeat_interleave(torch.arange(len(lengths)),
                                  torch.tensor(lengths))
    check(ids.numel() == t, f"segment lengths {lengths} do not sum to {t}")
    return ids[None].repeat(b, 1).to(device=device, dtype=torch.int32)


def _flash_case(fa, b, t, h, d, causal, scale, qseg, kseg, seed, label,
                dtype=torch.bfloat16):
    """One shape: the three kernels against their plain versions on the
    same inputs, in ``dtype`` with its row limits; returns the errors by
    name and the inputs."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (_randn((b * h, t, d), gen, dtype) for _ in range(4))
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
        check(x.dtype == dtype and x.shape == q.shape, f"flash {label}: "
              f"{name} is {x.dtype} {tuple(x.shape)}")
    errs = {
        "o": _max_abs(o, ro),
        "ml": max(_rel_to_one(m, rm), _rel_to_one(l, rl)),
        "dq_abs": _max_abs(dq, rdq),
        "dkv_abs": max(_max_abs(dk, rdk), _max_abs(dv, rdv)),
    }
    lim = _row_limits(dtype)
    rows = {"o": _row_ratio(o, ro, *lim), "dq": _row_ratio(dq, rdq, *lim),
            "dk": _row_ratio(dk, rdk, *lim), "dv": _row_ratio(dv, rdv, *lim)}
    check(errs["o"] <= FLASH_O_TOL, f"flash {label}: o err {errs['o']}")
    check(errs["ml"] <= FLASH_ML_TOL, f"flash {label}: m/l err "
          f"{errs['ml']}")
    for name, ratio in rows.items():
        check(ratio <= 1.0, f"flash {label}: {name} row error at {ratio:.3g}"
              f" x its limit")
    print(f"flash {label} {_short(dtype)} [B*H={b * h}, T={t}, D={d}] "
          f"causal={causal} scale={sc:.4g}: o max abs {errs['o']:.3g}, m/l rel "
          f"{errs['ml']:.3g}; worst row / limit: " + ", ".join(
              f"{n} {r:.3g}" for n, r in rows.items()), flush=True)
    return errs, (q, k, v, do)


def _flash_grad_case(fa, b, t, h, d, seg, seed, label,
                     dtype=torch.bfloat16):
    """The autograd Function ([B, T, H, D] read in place): its o against
    the plain forward, and its gradients against the plain backward fed
    the o the Function saved.  The backward takes di = rowsum(dO*O) from
    that bf16 o, as the TPU kernels do, so a reference with another o (the
    plain forward's, which differs by rounding flips, or autograd's f32
    one) moves di on rows whose attention sits on one key by several
    times the row limit."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (_randn((b, t, h, d), gen, dtype) for _ in range(4))
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
    check(out.dtype == dtype and all(x.dtype == dtype for x in got),
          f"flash grads {label}: outputs not in {dtype}")
    rows = {name: _row_ratio(fa._fold(a), w, *_row_limits(dtype))
            for name, a, w in zip(("o", "dq", "dk", "dv"), (out,) + got,
                                  (ro,) + want)}
    for name, ratio in rows.items():
        check(ratio <= 1.0, f"flash grads {label}: {name} row error at "
              f"{ratio:.3g} x its limit")
    print(f"flash grads {label} {_short(dtype)} [{b}, {t}, {h}, {d}]: "
          f"Function vs the plain "
          f"versions; worst row / limit: " + ", ".join(
              f"{n} {r:.3g}" for n, r in rows.items()), flush=True)


def _attention_flops(b, t, h, d, causal, per_pair):
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    return per_pair * d * pairs


def _bound(flops, nbytes, ops_per_s=BF16_OPS_PER_S):
    ops_ms = flops / ops_per_s * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def phase_flash_check() -> list:
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

    rows = _flash_rows(fa, b, t, h, d, torch.bfloat16, main, "")

    # The other instances: f16 and f32 at the LM's shape, head dim 256 at
    # the 256-wide-head LM's (phase 7 (c)); small cases at D 256 and at the
    # padded 80 and 96 (non-causal, a fully masked row, ragged T, tiles
    # cut by T); the Function's gradients in every dtype.
    for i, (dtype, hh, dd) in enumerate(FLASH_INSTANCES):
        errs, _ = _flash_case(fa, b, t, hh, dd, True, None, None, None,
                              40 + i, "main shape", dtype)
        rows += _flash_rows(fa, b, t, hh, dd, dtype, errs,
                            f"_{_short(dtype)}_d{dd}")
    qseg = _segments(2, 192, [64, 64, 40, 24])
    kseg = _segments(2, 192, [64, 64, 64])
    for i, dtype in enumerate((torch.bfloat16, torch.float16,
                               torch.float32)):
        _, (q, k, v, do) = _flash_case(fa, 2, 192, 2, 256, False, None,
                                       qseg, kseg, 50 + i,
                                       "D=256 fully masked rows", dtype)
        o, m, l = fa._fwd_parts(q, k, v, qseg, kseg, False, 256 ** -0.5)
        check(bool((o[:, 168:] == 0).all()) and
              bool((l[:, 0, 168:] == 0).all()),
              f"D=256 {dtype}: fully masked rows must give o = 0, l = 0")
        _flash_case(fa, 2, 320, 2, 80, True, None, None, None, 53 + i,
                    "padded D=80 causal T=320", dtype)
        _flash_case(fa, 1, 40, 2, 96, True, None, None, None, 56 + i,
                    "padded D=96 ragged T=40", dtype)
        seg = _segments(2, 512, [100, 200, 150, 62])
        _flash_case(fa, 2, 512, 2, 256, True, 0.05, seg, seg, 59 + i,
                    "D=256 segments T=512", dtype)
        _flash_grad_case(fa, 2, 256, 2, 128, None, 62 + i, "T=256", dtype)
        _flash_grad_case(fa, 1, 192, 2, 256, _segments(1, 192, [100, 92]),
                         65 + i, "D=256 segments T=192", dtype)
        _flash_grad_case(fa, 2, 128, 2, 96, None, 68 + i, "padded D=96",
                         dtype)
    # The wide instances (head dims above 256, padded to a multiple of
    # 256) in each dtype: a fully masked row, a padded D 320 with ragged
    # T, segment borders inside tiles with a custom scale, three column
    # blocks (D 768) with tiles cut by T, and the Function's gradients
    # packed and at a padded D 384; the planted fault builds meanwhile.
    fault = _planted_wide_fault_start()
    for i, dtype in enumerate((torch.bfloat16, torch.float16,
                               torch.float32)):
        _, (q, k, v, do) = _flash_case(fa, 2, 192, 2, 512, False, None,
                                       qseg, kseg, 71 + i,
                                       "D=512 fully masked rows", dtype)
        o, m, l = fa._fwd_parts(q, k, v, qseg, kseg, False, 512 ** -0.5)
        check(bool((o[:, 168:] == 0).all()) and
              bool((l[:, 0, 168:] == 0).all()),
              f"D=512 {dtype}: fully masked rows must give o = 0, l = 0")
        _flash_case(fa, 1, 40, 2, 320, True, None, None, None, 74 + i,
                    "padded D=320 ragged T=40", dtype)
        seg = _segments(2, 512, [100, 200, 150, 62])
        _flash_case(fa, 2, 512, 2, 512, True, 0.05, seg, seg, 77 + i,
                    "D=512 segments T=512", dtype)
        _flash_case(fa, 2, 320, 2, 768, True, None, None, None, 80 + i,
                    "D=768 causal T=320", dtype)
        _flash_grad_case(fa, 1, 192, 2, 512, _segments(1, 192, [100, 92]),
                         83 + i, "D=512 segments T=192", dtype)
        _flash_grad_case(fa, 2, 128, 2, 384, None, 86 + i, "padded D=384",
                         dtype)
    _planted_wide_fault_check(fa, fault)
    return rows


def _planted_wide_fault_start():
    """nvcc started on a copy of flash_attention.cu with
    PLANTED_WIDE_FAULT: ``(process, library, directory)``."""
    import os
    import tempfile

    from horovod_tpu_torch.ops import _build

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fault_")
    with open(os.path.join(_build.CSRC, "flash_attention.cu")) as f:
        src = f.read()
    old, new = PLANTED_WIDE_FAULT
    check(src.count(old) == 1, "the planted fault's text is not in "
          "flash_attention.cu once")
    cu = os.path.join(tmp, "flash_attention.cu")
    lib = os.path.join(tmp, "libfault.so")
    with open(cu, "w") as f:
        f.write(src.replace(old, new))
    proc = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o",
         lib, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, lib, tmp


def _planted_wide_fault_check(fa, started) -> None:
    """The bf16 wide forward with PLANTED_WIDE_FAULT against the plain
    version at [2, 2048, 2, 512] causal: the row check passes the kernel
    and must fail the faulty copy."""
    import ctypes
    import shutil

    from horovod_tpu_torch.ops import _build

    proc, lib, tmp = started
    try:
        out, _ = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"nvcc failed on the planted fault: "
              f"{out[-2000:]}")
        gen = torch.Generator(device="cuda").manual_seed(90)
        q, k, v = (_randn((4, 2048, 512), gen) for _ in range(3))
        sc = 512 ** -0.5
        ro, _, _ = fa._fwd_parts_plain(q, k, v, None, None, True, sc)
        good, _, _ = fa._fwd_parts(q, k, v, None, None, True, sc)
        kept = _build._libs["flash_attention"]
        _build._libs["flash_attention"] = ctypes.CDLL(lib)
        try:
            bad, _, _ = fa._fwd_parts(q, k, v, None, None, True, sc)
            torch.cuda.synchronize()
        finally:
            _build._libs["flash_attention"] = kept
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    ok, faulty = _row_ratio(good, ro), _row_ratio(bad, ro)
    check(ok <= 1.0 < faulty, f"planted wide fault: the kernel's o reads "
          f"{ok:.3g} x its row limit, the faulty copy's {faulty:.3g} x "
          f"(must be <= 1 and > 1)")
    print(f"flash planted fault (bf16 wide forward drops the last head-dim "
          f"chunk of S from q row 1024 on) [B*H=4, T=2048, D=512]: o worst "
          f"row / limit {ok:.3g} for the kernel, {faulty:.3g} for the "
          f"faulty copy: caught", flush=True)


def _flash_rows(fa, b, t, h, d, dtype, errs, suffix) -> list:
    """The kernels' rows of the kernels line at ``[B, T, H, D]`` in
    ``dtype`` (causal, the main path's layout, read in place): each
    kernel's ms beside its plain version's, its bound (f32 at the
    three-pass TF32 rate, bf16 and f16 at the tensor cores') and SDPA's in
    the same dtype, with the backend PyTorch picked for it; ``errs`` are
    the main-shape case's errors.  The f32 rows name the tensor-core
    kernels (tf32x3) up to D 256 and the CUDA-core ones (ffma) above."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(20)
    q, k, v, do = (_randn((b, t, h, d), gen, dtype) for _ in range(4))
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
    backend = _sdpa_backend(qh, kh, vh)
    del out, leaves
    size = torch.finfo(dtype).bits // 8
    n = b * t * h * d * size                 # bytes of one operand
    ml = 2 * b * h * t * 4                   # m and l, f32
    work = {
        "fwd": (_attention_flops(b, t, h, d, True, 4), 4 * n + ml),
        "dq": (_attention_flops(b, t, h, d, True, 6), 6 * n + ml),
        "dkv": (_attention_flops(b, t, h, d, True, 8), 7 * n + ml),
    }
    f32 = dtype == torch.float32
    rows = []
    for key, name, line, err in (
            ("fwd", "flash_attention_fwd", 108, errs["o"]),
            ("dq", "flash_attention_bwd_dq", 173, errs["dq_abs"]),
            ("dkv", "flash_attention_bwd_dkv", 226, errs["dkv_abs"])):
        bound_ms, bound_by = _bound(*work[key], TF32X3_OPS_PER_S if f32
                                    else BF16_OPS_PER_S)
        if f32:
            name += "_tf32x3" if d <= 256 else "_ffma"
        rows.append({
            "name": name + suffix, "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/flash_attention" +
                      ("_f32.cu" if f32 else ".cu"),
            "replaces": f"horovod_tpu/ops/flash_attention.py:{line}",
            "launches": None, "max_abs_err": err, "ms": ms[key],
            "plain_ms": plain_ms[key], "bound_ms": bound_ms,
            "bound_by": bound_by,
            # dq and dkv share SDPA's one backward time.
            "library_ms": sdpa_fwd if key == "fwd" else sdpa_bwd,
            "library_backend": backend,
            "flops": work[key][0], "bytes": work[key][1],
            # (kernel, instance, head dim): which counter its launches
            # are read from; dropped before the line is printed.
            "instance": ("fwd" if key == "fwd" else "bwd_" + key,
                         _short(dtype), d),
        })
        print(f"{name + suffix} at [{b}, {t}, {h}, {d}] {_short(dtype)} "
              f"causal: kernel {ms[key]:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}: {work[key][0]:.4g} FLOP, {work[key][1]} bytes; "
              f"{bound_ms / ms[key] * 100:.1f} % of bound), plain "
              f"{plain_ms[key]:.4f} ms", flush=True)
    print(f"scaled_dot_product_attention at [{b}, {h}, {t}, {d}] "
          f"{_short(dtype)} causal ({backend}): forward {sdpa_fwd:.4f} ms, "
          f"backward {sdpa_bwd:.4f} ms, forward+backward "
          f"{sdpa_fwd_bwd:.4f} ms", flush=True)
    return rows


def _sdpa_backend(q, k, v) -> str:
    """The backend ``scaled_dot_product_attention`` picks for causal
    ``[B, H, T, D]`` operands: the ``aten::_scaled_dot_product_<backend>``
    op one call records on the host (its flash backend stops at head dim
    256)."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        F.scaled_dot_product_attention(q, k, v, is_causal=True)
    prefix = "aten::_scaled_dot_product_"
    names = sorted({e.key[len(prefix):] for e in prof.key_averages()
                    if e.key.startswith(prefix)})
    return ", ".join(names) or "math"


def flash_f32_readings() -> None:
    """The f32 kernels' rows against the plain versions at phase 6's
    shapes, each worst row with its reference's norm, and both versions'
    distances from an f64 reference (dense attention on 4 batch*heads):
    the readings behind FLASH_F32_ROW_ATOL."""
    from horovod_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False

    def f64_grads(q, k, v, do, scale):
        q, k, v, do = (x.double() for x in (q, k, v, do))
        t = q.shape[1]
        s = (q @ k.transpose(1, 2) * scale).masked_fill(torch.ones(
            t, t, dtype=torch.bool, device="cuda").triu(1), float("-inf"))
        p = torch.softmax(s, -1)
        o = p @ v
        ds = p * (do @ v.transpose(1, 2) - (do * o).sum(-1, keepdim=True))
        return o, ds @ k * scale, ds.transpose(1, 2) @ q * scale, \
            p.transpose(1, 2) @ do

    def row_errs(a, b):
        a, b = a.double().flatten(0, -2), b.double().flatten(0, -2)
        return (a - b).norm(dim=-1), b.norm(dim=-1)

    for bh, d in ((96, 128), (48, 256)):
        gen = torch.Generator(device="cuda").manual_seed(40)
        q, k, v, do = (torch.randn((bh, 2048, d), generator=gen,
                                   device="cuda") for _ in range(4))
        sc = d ** -0.5
        ro, rm, rl = fa._fwd_parts_plain(q, k, v, None, None, True, sc)
        o, _, _ = fa._fwd_parts(q, k, v, None, None, True, sc)
        kern = (o,) + fa._bwd_parts(q, k, v, ro, do, rm, rl, None, None,
                                    True, sc)
        plain = (ro,) + fa._bwd_parts_plain(q, k, v, ro, do, rm, rl, None,
                                            None, True, sc)
        truth = f64_grads(q[:4], k[:4], v[:4], do[:4], sc)
        for name, a, b, tr in zip(("o", "dq", "dk", "dv"), kern, plain,
                                  truth):
            err, ref = row_errs(a, b)
            ratio = torch.where(err == 0, 0.0, err / (
                FLASH_F32_ROW_RTOL * ref + FLASH_F32_ROW_ATOL * ref.median()))
            i = int(ratio.argmax())
            ek, _ = row_errs(a[:4], tr)
            ep, _ = row_errs(b[:4], tr)
            print(f"f32 D={d} {name}: worst row (batch*head {i // 2048}, "
                  f"t {i % 2048}) at {ratio[i].item():.3g}x its limit: "
                  f"||err|| {err[i].item():.3g}, ||ref|| {ref[i].item():.3g},"
                  f" median ||ref|| {ref.median().item():.3g}; max row "
                  f"distance from f64 (4 batch*heads): kernel "
                  f"{ek.max().item():.3g}, plain {ep.max().item():.3g}",
                  flush=True)
        # dq of each sequence's first query is 0 in exact arithmetic (its
        # one visible key is itself, o = v there): what is left there is
        # the version's own rounding, over every batch*head.
        print(f"f32 D={d} dq of the first query (0 exactly), largest row "
              f"norm over {bh} batch*heads: kernel "
              f"{kern[1][:, 0].norm(dim=-1).max().item():.3g}, plain "
              f"{plain[1][:, 0].norm(dim=-1).max().item():.3g}", flush=True)


def phase_lm_main_path(smi: str) -> tuple:
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
    summary["step_losses"] = res["step_losses"]
    return counts, summary


def _instance_counts(fa) -> dict:
    """The flash launches by instance since the counters' last reset:
    ``{(instance, head dim): {kernel: launches}}`` of those above 0."""
    out = {}
    for (kind, inst, d), c in fa.instance_launches.items():
        if c.count:
            out.setdefault((inst, d), {})[kind] = c.count
    return out


def phase_lm_f32(smi: str, lm7: dict) -> dict:
    """Phase 7 (b): the LM of record at f32 with ``attention="flash"``
    (TF32 off), its state by ``make_lm_bench_state``'s recipe in f32 (f32
    momentum) as ``python -m horovod_tpu_torch.benchmark --model lm
    --lm-dtype float32`` profiles it, LM_F32_STEPS steps: tok/s, the f32
    kernels' launches (one of each a layer and step) and the first loss
    against the same forward through the local route."""
    from horovod_tpu_torch.benchmark import make_lm_bench_state
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b, t = LM["batch_size"], LM["seq_len"]
    st = make_lm_bench_state(**LM, compute_dtype="float32",
                             momentum_dtype="float32")
    model, cfg, tokens, labels = st.model, st.cfg, st.tokens, st.labels
    with torch.no_grad():
        local = float(tfm.xent(tfm.forward(model.tree(), tokens, cfg,
                                           attention="local"), labels))
    step = tfm.make_train_step(model, st.optimizer, st.mesh, st.axis,
                               attention="flash")
    for c in fa.instance_launches.values():
        c.reset()
    warm, timed = LM_F32_STEPS
    losses = [step(tokens, labels) for _ in range(warm)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(tokens, labels) for _ in range(timed)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / timed * 1e3
    counts = _instance_counts(fa)
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    want = cfg.n_layers * (warm + timed)
    check(counts == {("f32", 128): {"fwd": want, "bwd_dq": want,
                                    "bwd_dkv": want}},
          f"f32 LM: flash launches {counts}, expected {want} of each f32 "
          f"kernel at head dim 128 and no other")
    check(all(x == x and abs(x) != float("inf") for x in losses),
          f"f32 LM losses not finite: {losses}")
    rel = abs(losses[0] - local) / abs(local)
    check(rel <= LM_F32_LOSS_RTOL, f"f32 LM first loss {losses[0]} vs the "
          f"local route's {local}: relative {rel:.3g}")
    summary = {"dtype": "float32", "attention": "flash", "batch_size": b,
               "seq_len": t, "ms_per_step": ms,
               "tok_sec_per_chip": b * t / ms * 1e3, "step_losses": losses,
               "first_loss_local": local, "first_loss_rel": rel,
               "max_memory_allocated": peak,
               "flash_launches": counts[("f32", 128)], "nvidia_smi": smi}
    print(f"LM f32 of record (phase 7 (b)): {summary['tok_sec_per_chip']:.1f}"
          f" tok/s ({ms:.1f} ms/step; phase 7 bf16: "
          f"{lm7['tok_sec_per_chip']:.1f} tok/s); first loss {losses[0]:.7f}"
          f" vs local {local:.7f} (rel {rel:.3g}, limit "
          f"{LM_F32_LOSS_RTOL}); f32 flash launches "
          f"{counts[('f32', 128)]}; " + json.dumps(summary), flush=True)
    del step, st, model, tokens, labels
    torch.cuda.empty_cache()
    return counts


def phase_lm_wide(smi: str, lm7: dict) -> dict:
    """Phase 7 (c): the LM of record's width with 12 heads of 256 (bf16,
    flash) through ``run_lm_benchmark``: tok/s beside phase 7's and the
    head-dim-256 kernels' launches."""
    from horovod_tpu_torch.benchmark import run_lm_benchmark
    from horovod_tpu_torch.ops import flash_attention as fa

    torch.cuda.empty_cache()
    for c in fa.instance_launches.values():
        c.reset()
    warm, timed = LM_WIDE_STEPS
    res = run_lm_benchmark(
        **LM_WIDE, attention="flash", remat="none", momentum_dtype="bfloat16",
        num_warmup_batches=warm, num_batches_per_iter=1, num_iters=timed)
    counts = _instance_counts(fa)
    want = LM_WIDE["n_layers"] * (warm + timed)
    check(counts == {("bf16", 256): {"fwd": want, "bwd_dq": want,
                                     "bwd_dkv": want}},
          f"H12 LM: flash launches {counts}, expected {want} of each bf16 "
          f"kernel at head dim 256 and no other")
    check(all(x == x and abs(x) != float("inf") for x in res["step_losses"]),
          f"H12 LM losses not finite: {res['step_losses']}")
    print(f"LM d3072/H12 (head dim 256, phase 7 (c)): "
          f"{res['tok_sec_per_chip']:.1f} tok/s ({res['ms_per_step']:.1f} "
          f"ms/step) beside phase 7's H24 {lm7['tok_sec_per_chip']:.1f} "
          f"tok/s; losses {res['step_losses'][0]:.6f} -> "
          f"{res['step_losses'][-1]:.6f}; bf16 D=256 flash launches "
          f"{counts[('bf16', 256)]}; peak memory "
          f"{res['max_memory_allocated']}; {smi}", flush=True)
    torch.cuda.empty_cache()
    return counts


def phase_lm_wide512(smi: str, lm7: dict) -> dict:
    """Phase 7 (d): the LM of record's width with 6 heads of 512 (bf16,
    flash) through ``run_lm_benchmark``: tok/s and peak memory beside
    phase 7's, and the wide instances' launches (head dim 512, bf16), of
    each exactly one a layer and step and of no other instance."""
    from horovod_tpu_torch.benchmark import run_lm_benchmark
    from horovod_tpu_torch.ops import flash_attention as fa

    torch.cuda.empty_cache()
    for c in fa.instance_launches.values():
        c.reset()
    warm, timed = LM_WIDE_STEPS
    res = run_lm_benchmark(
        **LM_WIDE512, attention="flash", remat="none",
        momentum_dtype="bfloat16", num_warmup_batches=warm,
        num_batches_per_iter=1, num_iters=timed)
    counts = _instance_counts(fa)
    want = LM_WIDE512["n_layers"] * (warm + timed)
    check(counts == {("bf16", 512): {"fwd": want, "bwd_dq": want,
                                     "bwd_dkv": want}},
          f"H6 LM: flash launches {counts}, expected {want} of each bf16 "
          f"kernel at head dim 512 and no other")
    check(all(x == x and abs(x) != float("inf") for x in res["step_losses"]),
          f"H6 LM losses not finite: {res['step_losses']}")
    summary = {k: res[k] for k in (
        "d_model", "n_layers", "n_heads", "seq_len", "batch_size",
        "tok_sec_per_chip", "ms_per_step", "mfu", "max_memory_allocated",
        "step_losses")}
    summary["nvidia_smi"] = smi
    print(f"LM d3072/H6 (head dim 512, phase 7 (d)): "
          f"{res['tok_sec_per_chip']:.1f} tok/s ({res['ms_per_step']:.1f} "
          f"ms/step) beside phase 7's H24 {lm7['tok_sec_per_chip']:.1f} "
          f"tok/s ({lm7['ms_per_step']:.1f} ms/step); losses "
          f"{res['step_losses'][0]:.6f} -> {res['step_losses'][-1]:.6f}; "
          f"bf16 D=512 flash launches {counts[('bf16', 512)]}; peak memory "
          f"{res['max_memory_allocated']}; {smi}; " + json.dumps(summary),
          flush=True)
    torch.cuda.empty_cache()
    return counts


def _small_lm_params(cfg, seed):
    """A seeded LM parameter tree (numpy), as the port's state_dict."""
    from horovod_tpu_torch.models.convert import lm_params_to_torch

    return lm_params_to_torch(_small_lm_tree(cfg, seed))


def _small_lm_tree(cfg, seed):
    """A seeded LM parameter tree of numpy arrays (the JAX layout)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, cfg.d_ff

    def dense(shape, scale=None):
        return rng.standard_normal(shape) * (scale or shape[0] ** -0.5)

    def norm():
        return 1.0 + 0.2 * rng.standard_normal(d)

    return {
        "embed": dense((cfg.vocab_size, d), 0.02),
        "pos": dense((cfg.max_seq, d), 0.02),
        "ln_f_scale": norm(),
        "layers": [{"ln1_scale": norm(), "ln2_scale": norm(),
                    "wq": dense((d, d)), "wk": dense((d, d)),
                    "wv": dense((d, d)), "wo": dense((d, d)),
                    "w1": dense((d, f)), "w2": dense((f, d))}
                   for _ in range(cfg.n_layers)],
    }


def phase_lm_reference() -> dict:
    """A small f32 LM step on the GPU against the CPU and, on the GPU,
    through the flash route against the local one; then small packed LMs
    (SMALL_FLASH_LMS) whose logits and gradients go through the flash
    route against the local one.  Returns the packed LMs' flash launches
    by instance."""
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
    counts = {}
    for dev, group, route in (("cuda", None, "local"), ("cpu", gloo, "local"),
                              ("cuda", None, "flash")):
        model = tfm.TransformerLM(cfg, device=dev)
        model.load_state_dict(sd)
        opt = SGD([p for _, p in lm_ordered_parameters(model)], 0.1, 0.9,
                  torch.bfloat16)
        step = tfm.make_train_step(model, opt, build_mesh(group, dev),
                                   attention=route)
        for c in fa.instance_launches.values():
            c.reset()
        loss = step(tokens.to(dev), labels.to(dev))
        loss2 = step(tokens.to(dev), labels.to(dev))
        _add_counts(counts, _instance_counts(fa))
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        state.update({f"trace{i}": t.float().cpu()
                      for i, t in enumerate(opt.trace)})
        out[(dev, route)] = (float(loss), float(loss2), state)
    (lg, lg2, sg), (lc, lc2, sc) = out[("cuda", "local")], \
        out[("cpu", "local")]
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
    # The same two steps through the flash route on the card (the f32
    # kernels at head dim 16), held to the local route's.
    lf, lf2, sf = out[("cuda", "flash")]
    want = 2 * cfg.n_layers
    check(counts == {("f32", 16): {"fwd": want, "bwd_dq": want,
                                   "bwd_dkv": want}},
          f"small f32 LM flash route: launches {counts}")
    for a, c in ((lf, lg), (lf2, lg2)):
        check(abs(a - c) <= 1e-5 * abs(c),
              f"small f32 LM loss flash {a} vs local {c}")
    worst = max((sf[k] - sg[k]).abs().max().item() for k in sg)
    check(worst <= 1e-4, f"small f32 LM state after two steps differs by "
          f"{worst} between the flash and local routes")
    print(f"LM reference: small f32 LM, two steps on the card, flash "
          f"losses {lf:.7f} {lf2:.7f} vs local {lg:.7f} {lg2:.7f} (relative"
          f" tolerance 1e-5); params and momentum max abs diff {worst:.3g} "
          f"(tolerance 1e-4); f32 D=16 launches {counts[('f32', 16)]}",
          flush=True)
    counts = {}

    # The flash route inside the model ([B, T, H, D] read in place, the
    # segment ids passed through) against the local route, both on the
    # GPU in the same dtype, packed, the same weights.  The loss alone has
    # no power here (about ln 512 at random init whatever attention
    # returns), so the logits and the gradients are compared; the loss is
    # printed only.
    for dtype, width in SMALL_FLASH_LMS:
        _add_counts(counts, _small_flash_lm(tfm, fa, dtype, width))
    return counts


def _add_counts(total: dict, more: dict) -> None:
    for key, by_kind in more.items():
        for kind, n in by_kind.items():
            total.setdefault(key, {}).setdefault(kind, 0)
            total[key][kind] += n


def _small_flash_lm(tfm, fa, dtype, width) -> dict:
    """Phase 8's packed LM of ``width`` at 2 heads in ``dtype``: logits
    and gradients through the flash route against the local route on the
    card; returns the flash launches by instance."""
    import numpy as np

    from horovod_tpu_torch.models.convert import lm_ordered_parameters

    cfg = tfm.TransformerConfig(vocab_size=512, d_model=width, n_heads=2,
                                n_layers=2, d_ff=512, max_seq=256,
                                dtype=dtype)
    model = tfm.TransformerLM(cfg, generator=torch.Generator(
        device="cuda").manual_seed(2), device="cuda")
    leaves = [p for _, p in lm_ordered_parameters(model)]
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (2, 257))).cuda()
    seg = _segments(2, 256, [100, 60, 96])
    counters = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    before = [c.count for c in counters]
    for c in fa.instance_launches.values():
        c.reset()
    out = {}
    for route in ("flash", "local"):
        logits = tfm.forward(model.tree(), toks[:, :-1], cfg,
                             attention=route, segment_ids=seg)
        loss = tfm.xent(logits, toks[:, 1:])
        out[route] = (logits.detach(), float(loss.detach()),
                      torch.autograd.grad(loss, leaves))
    counts = _instance_counts(fa)
    inst = (_short(dtype), width // 2)
    check([c.count - n for c, n in zip(counters, before)] ==
          [cfg.n_layers] * 3 and counts == {inst: {
              "fwd": cfg.n_layers, "bwd_dq": cfg.n_layers,
              "bwd_dkv": cfg.n_layers}},
          f"the flash route did not launch the {inst} forward, dq and dkv "
          f"kernels once per layer: {counts}")
    (lf, loss_f, gf), (ll, loss_l, gl) = out["flash"], out["local"]
    logit_err = ((lf - ll).norm(dim=-1) / ll.norm(dim=-1)).max().item()
    grad_err = {name: ((a - b).norm() / b.norm()).item()
                for (name, _), a, b in zip(lm_ordered_parameters(model), gf,
                                           gl)}
    worst = max(grad_err, key=grad_err.get)
    logit_tol, grad_tol = ((LM_F32_FLASH_TOL, LM_F32_FLASH_TOL)
                           if dtype == torch.float32
                           else (LM_LOGIT_TOL, LM_GRAD_TOL))
    label = f"small {_short(dtype)} LM d{width} (head dim {width // 2})"
    check(logit_err <= logit_tol, f"{label} logits flash vs local: worst "
          f"row {logit_err:.3g} > {logit_tol}")
    check(grad_err[worst] <= grad_tol, f"{label} grads flash vs local: "
          f"{worst} {grad_err[worst]:.3g} > {grad_tol}")
    print(f"LM reference: {label}, packed, on the GPU, flash vs local "
          f"route: logits worst row {logit_err:.3g} (max abs "
          f"{_max_abs(lf, ll):.3g}; tolerance {logit_tol}), grads worst "
          f"leaf {worst} {grad_err[worst]:.3g} (median "
          f"{statistics.median(grad_err.values()):.3g}; tolerance "
          f"{grad_tol}); loss {loss_f:.6f} vs {loss_l:.6f}; launches "
          f"{counts[inst]}", flush=True)
    return counts


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


def _hooked_resnet_step(hvd, st):
    """Phase 4's step on ``st`` with every gradient submitted as a named
    ``allreduce_async(op=Average)`` from its autograd hook, in the order
    autograd produces them, and synchronized before the SGD update.
    Returns the step, the parameters and what removes the hooks."""
    import torch.nn.functional as F

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

    def remove():
        for h in hooks:
            h.remove()

    return step, params, remove


def phase_control_plane(smi: str, main: dict) -> dict:
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
    step, params, remove = _hooked_resnet_step(hvd, st)
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
    remove()
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


# ---------------------------------------------------------------------------
# Sequence and tensor parallelism
# ---------------------------------------------------------------------------

def _expected_flash_launches(variant: str, causal: bool, n: int) -> int:
    """Launches of each flash kernel in one forward and backward over
    ``n`` ranks: ring-flash runs the kernels on every ring step whose
    block is visible (rank i: 1 + i steps under causal, n without),
    Ulysses once per rank over the whole sequence, ring never."""
    if variant == "ring_flash":
        return n * (n + 1) // 2 if causal else n * n
    return n if variant == "ulysses" else 0


def _virtual_attention(variant, q, k, v, w, seg, causal, n):
    """``variant`` over ``n`` virtual ranks (threads, one sequence chunk
    each) on the inputs' device: the forward, then the backward of
    ``sum(o * w)``; returns o, dq, dk, dv joined over the ranks.  Ring
    and Ulysses are the package's functions, their exchanges swapped for
    in-memory ones, with one backward over every rank's output;
    ring-flash's forward and backward passes are called directly."""
    from horovod_tpu_torch.parallel import sequence as sq

    tl = q.shape[1] // n
    scale = q.shape[-1] ** -0.5

    def shard(x, i):
        return x[:, i * tl:(i + 1) * tl].contiguous()

    flash = variant == "ring_flash"
    ins = [[shard(x, i).requires_grad_(not flash) for x in (q, k, v)]
           for i in range(n)]

    def rank(ax):
        i = ax.index
        sg = shard(seg, i) if seg is not None else None
        if flash:
            o, res = sq._ring_flash_fwd(*ins[i], ax, causal, scale, sg)
            return (o,) + sq._ring_flash_bwd(ax, causal, scale, res,
                                             shard(w, i))
        if variant == "ring":
            return sq.ring_attention(*ins[i], ax, causal, segment_ids=sg)
        return sq.ulysses_attention(*ins[i], ax, causal, segment_ids=sg,
                                    use_flash=True)

    outs = sq.VirtualAxis(n).run(rank)
    if flash:
        return [torch.cat([o[j] for o in outs], 1) for j in range(4)]
    grads = torch.autograd.grad(outs, [x for r in ins for x in r],
                                [shard(w, i) for i in range(n)])
    return [torch.cat(outs, 1).detach()] + [torch.cat(grads[j::3], 1)
                                            for j in range(3)]


def _wall_ms(fn, device, runs: int) -> float:
    """Median host milliseconds of ``fn()`` ended by a synchronize (the
    virtual ranks launch from four threads), after one warmup."""
    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    fn()
    times = []
    for _ in range(runs):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_sequence_parallel(smi: str, device="cuda", shape=None) -> list:
    """Phase 11 (a): ring-flash, ring and Ulysses attention at 4 virtual
    ranks, held row by row to ``flash_attention`` over the whole
    sequence; returns the flash launches of the checked runs."""
    from horovod_tpu_torch.ops import flash_attention as fa

    b, tg, h, d, n = (shape or SP_SHAPE)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(31)
    q, k, v, w = (torch.randn((b, tg, h, d), generator=gen, device=device)
                  .to(torch.bfloat16) for _ in range(4))
    seg = _segments(b, tg, SP_SEGMENTS, device)
    counters = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    on_card = torch.device(device).type == "cuda"
    path = [0, 0, 0]
    for causal, packed in SP_CASES:
        sg = seg if packed else None
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        ref_o = fa.flash_attention(*leaves, causal=causal, segment_ids=sg)
        refs = {torch.bfloat16: [ref_o.detach()] + list(
            torch.autograd.grad(ref_o, leaves, w))}
        del leaves, ref_o
        # The plain version over the whole sequence in f32, for the f32
        # ring.
        qf, kf, vf, wf = (fa._fold(x.float()) for x in (q, k, v, w))
        of, m, l = fa._fwd_parts_plain(qf, kf, vf, sg, sg, causal, d ** -0.5)
        refs[torch.float32] = [fa._unfold(x, b, h) for x in (of,) + tuple(
            fa._bwd_parts_plain(qf, kf, vf, of, wf, m, l, sg, sg, causal,
                                d ** -0.5))]
        del qf, kf, vf, wf, of, m, l

        def whole():
            ls = [x.detach().requires_grad_() for x in (q, k, v)]
            torch.autograd.grad(fa.flash_attention(
                *ls, causal=causal, segment_ids=sg), ls, w)

        whole_ms = _wall_ms(whole, device, SP_TIMED_RUNS)
        label = (f"{'causal' if causal else 'non-causal'}"
                 f"{', packed' if packed else ''}")
        for variant, dtype, held in SP_VARIANTS:
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            ops = [x.to(dtype) for x in (q, k, v, w)]
            for c in counters:
                c.reset()
            got = _virtual_attention(variant, *ops, sg, causal, n)
            if on_card:
                torch.cuda.synchronize()
            launched = [c.count for c in counters]
            want = _expected_flash_launches(variant, causal, n)
            if on_card:
                check(launched == [want] * 3, f"phase 11 {variant} "
                      f"{label}: flash launches {launched}, expected "
                      f"{want} of each kernel")
            path = [a + x for a, x in zip(path, launched)]
            ref = refs[dtype if held else torch.bfloat16]
            err_o = _max_abs(got[0], ref[0])
            rows = {name: _row_ratio(a, r) for name, a, r in
                    zip(("o", "dq", "dk", "dv"), got, ref)}
            for name, x in zip(("o", "dq", "dk", "dv"), got):
                check(bool(torch.isfinite(x).all()), f"phase 11 {variant} "
                      f"{label}: {name} has non-finite values")
            if held:
                check(err_o <= FLASH_O_TOL, f"phase 11 {variant} {label}: o "
                      f"max abs err {err_o} > {FLASH_O_TOL}")
                for name, ratio in rows.items():
                    check(ratio <= 1.0, f"phase 11 {variant} {label}: "
                          f"{name} row error at {ratio:.3g} x its limit")
            peak = torch.cuda.max_memory_allocated() if on_card else None
            del got
            ms = _wall_ms(lambda: _virtual_attention(
                variant, *ops, sg, causal, n), device, SP_TIMED_RUNS)
            del ops
            against = ("the plain version in f32" if dtype == torch.float32
                       else "the kernels")
            print(f"phase 11 {variant} ({str(dtype)[6:]} operands, "
                  f"{'held to' if held else 'not held, beside'} {against} "
                  f"over the whole sequence) at {n} virtual ranks "
                  f"[B={b}, T_global={tg}, H={h}, D={d}] {label}: forward "
                  f"+ backward {ms:.3f} ms (flash_attention over the whole "
                  f"sequence, bf16: {whole_ms:.3f} ms) on {smi}; flash "
                  f"launches fwd/dq/dkv {launched} (expected {want} each); "
                  f"o max abs {err_o:.3g}; worst row / limit: " + ", ".join(
                      f"{k_} {r:.3g}" for k_, r in rows.items()) +
                  (f"; peak {peak} bytes" if peak is not None else ""),
                  flush=True)
        del refs
    return path


def phase_lm_parallel(smi: str, lm7: dict) -> list:
    """Phase 11 (b): the LM of record through the dp x tp x sp step on a
    1 x 1 x 1 (data, model, seq) NCCL mesh, with ring-flash and Ulysses
    attention; its losses held to phase 7's.  Returns the flash
    launches."""
    import torch.distributed as dist

    from horovod_tpu_torch.benchmark import make_lm_bench_state
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.topology import build_mesh

    mesh = build_mesh(axes=("data", "model", "seq"), shape=(1, 1, 1))
    check(mesh.backend == "nccl" and mesh.device == torch.device("cuda", 0),
          f"phase 11 mesh on {mesh.backend} {mesh.device}")
    counters = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    path = [0, 0, 0]
    steps = LM_WARMUP_STEPS + LM_TIMED_STEPS
    for route in ("ring_flash", "ulysses"):
        torch.cuda.empty_cache()
        st = make_lm_bench_state(
            LM["d_model"], LM["n_layers"], LM["n_heads"], LM["d_ff"],
            LM["vocab_size"], LM["seq_len"], LM["batch_size"],
            momentum_dtype="bfloat16", mesh=mesh)
        step = tfm.make_train_step(st.model, st.optimizer, mesh, "data",
                                   "model", "seq", attention=route)
        for c in counters:
            c.reset()
        losses = [step(st.tokens, st.labels) for _ in range(LM_WARMUP_STEPS)]
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        losses += [step(st.tokens, st.labels) for _ in range(LM_TIMED_STEPS)]
        t1.record()
        torch.cuda.synchronize()
        launched = [c.count for c in counters]
        path = [a + x for a, x in zip(path, launched)]
        losses = [float(x) for x in losses]
        timed = losses[LM_WARMUP_STEPS:]
        check(all(x == x and abs(x) != float("inf") for x in losses),
              f"phase 11 {route} LM losses not finite: {losses}")
        check(launched == [LM["n_layers"] * steps] * 3, f"phase 11 {route} "
              f"LM flash launches {launched}; expected {LM['n_layers']} "
              f"layers x {steps} steps of each kernel")
        rel = max(abs(a - b_) / abs(b_) for a, b_ in
                  zip(timed, lm7["step_losses"]))
        check(rel <= LM_SP_LOSS_RTOL, f"phase 11 {route} LM timed losses "
              f"{timed} vs phase 7's {lm7['step_losses']}: worst relative "
              f"difference {rel:.3g} > {LM_SP_LOSS_RTOL}")
        ms = t0.elapsed_time(t1) / LM_TIMED_STEPS
        tok = LM["batch_size"] * LM["seq_len"] / ms * 1e3
        print(f"phase 11 LM d{LM['d_model']}/L{LM['n_layers']}/"
              f"H{LM['n_heads']} T {LM['seq_len']} B {LM['batch_size']} "
              f"through the dp x tp x sp step on a 1x1x1 {dist.get_backend()}"
              f" mesh, attention={route}: {tok:,.0f} tok/s, {ms:.2f} "
              f"ms/step (phase 7: {lm7['tok_sec_per_chip']:,.0f} tok/s, "
              f"{lm7['ms_per_step']:.2f} ms/step) on {smi}; timed losses "
              f"{timed[0]:.6f} -> {timed[-1]:.6f}, worst relative "
              f"difference from phase 7's {rel:.3g} (tolerance "
              f"{LM_SP_LOSS_RTOL}); flash launches {launched}", flush=True)
        del st, step
    torch.cuda.empty_cache()
    return path


def _parallel_step_worker(rank, size, addr, backend, shape, out_dir):
    import os

    import numpy as np

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.optim import SGD
    from horovod_tpu_torch.topology import build_mesh

    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=addr)
    hvd.init(device=None if backend == "nccl" else "cpu")
    try:
        mesh = build_mesh(axes=("data", "model", "seq"), shape=shape)
        cfg = tfm.TransformerConfig(**SP_STEP_LM, dtype=torch.bfloat16)
        tree = _small_lm_tree(cfg, 7)
        model = tfm.TransformerLM(cfg, device=mesh.device,
                                  model_shards=shape[1])
        model.load_state_dict(convert.lm_params_to_shards(tree, mesh))
        named = convert.lm_ordered_parameters(model)
        opt = SGD([p for _, p in named], 0.1, momentum=0.9)
        step = tfm.make_train_step(model, opt, mesh, "data", "model", "seq",
                                   attention="ring_flash")
        t = cfg.max_seq
        toks = np.random.default_rng(8).integers(
            0, cfg.vocab_size, (SP_STEP_BATCH * shape[0], t + 1))
        d, s = mesh.axis_index("data"), mesh.axis_index("seq")
        rows = slice(d * SP_STEP_BATCH, (d + 1) * SP_STEP_BATCH)
        cols = slice(s * t // shape[2], (s + 1) * t // shape[2])
        tokens = torch.from_numpy(toks[rows, :-1][:, cols].copy())
        labels = torch.from_numpy(toks[rows, 1:][:, cols].copy())
        losses = [float(step(tokens.to(mesh.device), labels.to(mesh.device)))
                  for _ in range(2)]
        full = convert.lm_shards_to_params(model.state_dict(), mesh)
        torch.save({"losses": losses, "params": full, "init": tree},
                   f"{out_dir}/{backend}{rank}.pt")
    finally:
        hvd.shutdown()


def _spawn(fn, size, args, out_dir):
    """``fn(rank, size, addr, *args, out_dir)`` in ``size`` spawned
    processes that meet at a free local address; waits for them."""
    import socket

    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{sock.getsockname()[1]}"
    mp.start_processes(fn, args=(size, addr) + tuple(args) + (out_dir,),
                       nprocs=size, start_method="spawn")


def run_parallel_lm_step(backend: str, shape, out_dir: str) -> list:
    """Two dp x tp x sp steps of a small bf16 LM (ring-flash) on a mesh of
    ``shape`` over ``backend`` (NCCL: one card a rank; gloo: the CPU);
    each rank's losses and gathered parameters."""
    import math
    size = math.prod(shape)
    _spawn(_parallel_step_worker, size, (backend, tuple(shape)), out_dir)
    return [torch.load(f"{out_dir}/{backend}{r}.pt", weights_only=False)
            for r in range(size)]


def compare_parallel_lm_step(nccl: list, gloo: list) -> dict:
    """The worst loss difference (relative) and the worst leaf's update
    difference ``||du_nccl - du_gloo|| / ||du_gloo||`` over every rank,
    checked against SP_STEP_LOSS_RTOL and SP_STEP_UPDATE_TOL."""
    import numpy as np

    def leaves(tree):
        for key, val in tree.items():
            if key == "layers":
                for i, layer in enumerate(val):
                    for leaf, arr in layer.items():
                        yield f"layers.{i}.{leaf}", np.asarray(arr)
            else:
                yield key, np.asarray(val)

    worst_loss, worst_update = 0.0, ("", 0.0)
    for a, b in zip(nccl, gloo):
        for x, y in zip(a["losses"], b["losses"]):
            worst_loss = max(worst_loss, abs(x - y) / abs(y))
        init = dict(leaves(a["init"]))
        pb = dict(leaves(b["params"]))
        for name, pa in leaves(a["params"]):
            ua, ub = pa - init[name], pb[name] - init[name]
            err = float(np.linalg.norm(ua - ub) /
                        max(np.linalg.norm(ub), 1e-30))
            if err > worst_update[1]:
                worst_update = (name, err)
    check(worst_loss <= SP_STEP_LOSS_RTOL, f"parallel LM step losses nccl "
          f"vs gloo: {worst_loss:.3g} > {SP_STEP_LOSS_RTOL}")
    check(worst_update[1] <= SP_STEP_UPDATE_TOL, f"parallel LM step "
          f"updates nccl vs gloo: {worst_update} > {SP_STEP_UPDATE_TOL}")
    return {"loss_rel": worst_loss, "update_leaf": worst_update[0],
            "update_rel": worst_update[1]}


def phase_parallel_processes(smi: str) -> None:
    """Phase 11 (c): the NCCL path across processes, where the host has
    the cards for it."""
    import tempfile

    n = torch.cuda.device_count()
    if n < 2:
        print(f"phase 11 (c) did not run: {n} CUDA device here, and the "
              f"dp x tp x sp step across NCCL processes needs one card a "
              f"rank (2 for a 1x1x2 mesh, 4 for 1x2x2; NCCL refuses two "
              f"ranks on one card)", flush=True)
        return
    shape = (1, 2, 2) if n >= 4 else (1, 1, 2)
    with tempfile.TemporaryDirectory() as out:
        nccl = run_parallel_lm_step("nccl", shape, out)
        gloo = run_parallel_lm_step("gloo", shape, out)
    res = compare_parallel_lm_step(nccl, gloo)
    print(f"phase 11 (c): two dp x tp x sp steps of a small bf16 LM "
          f"(ring-flash) on a {shape} mesh over NCCL ({n} cards: {smi}) "
          f"against gloo on the CPU: " + json.dumps(res), flush=True)


# ---------------------------------------------------------------------------
# Decode, remat and pipeline parallelism
# ---------------------------------------------------------------------------

def _decode_step_bytes(cfg, batch: int, max_len: int) -> int:
    """Bytes one decode step must move: each matmul weight read once in
    bf16 (the layers' and the tied head's), the whole static K/V cache
    read once, the f32 logits written once."""
    d, f, v, n = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    weights = (n * (4 * d * d + 2 * d * f) + v * d) * 2
    cache = n * 2 * batch * max_len * d * 2
    return weights + cache + batch * v * 4


def _row_rel(a, b) -> float:
    """The worst row's ||a_r - b_r|| / ||b_r||, rows along the last dim."""
    a, b = a.float(), b.float()
    return ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()


def phase_decode(smi: str) -> list:
    """Phase 12 (a): the decode benchmark, the decode==forward oracle at
    the LM of record's width and generate against a step-by-step argmax.
    Returns the flash launches (the oracle's forward)."""
    import numpy as np

    from horovod_tpu_torch.benchmark import run_decode_benchmark
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa

    bench, device, dtype = DECODE_BENCH, "cuda", torch.bfloat16
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = run_decode_benchmark(**bench, verbose=False)
    peak = torch.cuda.max_memory_allocated()
    d = bench["d_model"]
    cfg = tfm.TransformerConfig(vocab_size=bench["vocab_size"], d_model=d,
                                n_heads=bench["n_heads"],
                                n_layers=bench["n_layers"], d_ff=4 * d)
    nbytes = _decode_step_bytes(cfg, bench["batch_size"],
                                bench["total_len"])
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    check(res["decode_tok_sec"] > 0 and res["ms_per_step"] > 0,
          f"phase 12 decode benchmark: {res}")
    print(f"phase 12 (a) decode d{d}/L{bench['n_layers']}/"
          f"H{bench['n_heads']} vocab {bench['vocab_size']} B "
          f"{bench['batch_size']} prompt {bench['prompt_len']} total "
          f"{bench['total_len']} {str(dtype)[6:]}: "
          f"{res['decode_tok_sec']:,.1f} tok/s, {res['ms_per_step']:.4f} "
          f"ms/step (byte bound {bound_ms:.4f} ms: {nbytes} bytes a step "
          f"at {HBM_BYTES_PER_S:.3g} B/s, "
          f"{bound_ms / res['ms_per_step'] * 100:.1f} % of bound); peak "
          f"{peak} bytes on {smi}", flush=True)

    cfg = tfm.TransformerConfig(
        vocab_size=LM["vocab_size"], d_model=LM["d_model"],
        n_heads=LM["n_heads"], n_layers=LM["n_layers"], d_ff=LM["d_ff"],
        max_seq=DECODE_MAX_LEN, dtype=dtype)
    n_pos, b = DECODE_POSITIONS, DECODE_BATCH
    model = tfm.TransformerLM(cfg, generator=torch.Generator(
        device=device).manual_seed(3), device=device)
    tree = model.tree()
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (b, n_pos))).to(device)
    with torch.no_grad():
        for c in (fa.fwd_launches, fa.dq_launches, fa.dkv_launches):
            c.reset()
        fwd = {"flash": tfm.forward(tree, toks, cfg, attention="flash")}
        launched = fa.fwd_launches.count
        fwd["local"] = tfm.forward(tree, toks, cfg, attention="local")
        cache = tfm.init_kv_cache(cfg, b, cfg.max_seq, device=device)
        worst = {"flash": 0.0, "local": 0.0}
        agree = 0
        for pos in range(n_pos):
            logits, cache = tfm.decode_step(tree, toks[:, pos], cache, pos,
                                            cfg)
            for route, ref in fwd.items():
                worst[route] = max(worst[route],
                                   _row_rel(logits, ref[:, pos]))
            agree += int((logits.argmax(-1) ==
                          fwd["flash"][:, pos].argmax(-1)).sum())
        del cache, fwd
        for route, err in worst.items():
            check(err <= DECODE_LOGIT_TOL, f"phase 12 decode_step vs "
                  f"forward({route}): worst row {err:.3g} > "
                  f"{DECODE_LOGIT_TOL}")
        p_len, total = DECODE_GENERATE
        prompt = toks[:, :p_len]
        out = tfm.generate(tree, prompt, total, cfg)
        cache = tfm.init_kv_cache(cfg, b, total, device=device)
        token, seq = prompt[:, 0], [prompt[:, 0]]
        for pos in range(total - 1):
            logits, cache = tfm.decode_step(tree, token, cache, pos, cfg)
            token = (prompt[:, pos + 1] if pos + 1 < p_len
                     else logits.argmax(-1))
            seq.append(token)
        check(tuple(out.shape) == (b, total) and
              torch.equal(out[:, :p_len], prompt),
              "phase 12 generate does not begin with its prompt")
        check(torch.equal(out, torch.stack(seq, 1)), "phase 12 generate's "
              "tokens differ from a step-by-step argmax of decode_step")
    print(f"phase 12 (a) decode==forward at d{cfg.d_model}/L{cfg.n_layers}/"
          f"H{cfg.n_heads} vocab {cfg.vocab_size} {str(dtype)[6:]}, cache "
          f"{cfg.max_seq}, {n_pos} positions x {b} sequences: worst row "
          f"vs flash {worst['flash']:.4g}, vs local {worst['local']:.4g} "
          f"(tolerance {DECODE_LOGIT_TOL}); argmax agrees with flash's on "
          f"{agree} of {n_pos * b} rows; generate({p_len} -> {total}) "
          f"equals the step-by-step argmax and keeps its prompt; flash "
          f"forward launches {launched}", flush=True)
    del model, tree
    return [launched, 0, 0]


def phase_remat(smi: str, lm7: dict) -> list:
    """Phase 12 (b): phase 7's benchmark under remat="dots" and "full",
    the flash launches checked against the policy's count and the losses
    held to phase 7's.  Returns the flash launches."""
    from horovod_tpu_torch.benchmark import run_lm_benchmark
    from horovod_tpu_torch.ops import flash_attention as fa

    counters = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    steps = LM_WARMUP_STEPS + LM_TIMED_STEPS
    path = [0, 0, 0]
    for remat in ("dots", "full"):
        torch.cuda.empty_cache()
        for c in counters:
            c.reset()
        res = run_lm_benchmark(
            **LM, attention="flash", remat=remat, momentum_dtype="bfloat16",
            num_warmup_batches=LM_WARMUP_STEPS, num_batches_per_iter=1,
            num_iters=LM_TIMED_STEPS, verbose=False)
        launched = [c.count for c in counters]
        path = [a + x for a, x in zip(path, launched)]
        n = LM["n_layers"] * steps
        want = [REMAT_FWD_PER_LAYER[remat] * n, n, n]
        check(launched == want, f"phase 12 remat={remat} flash launches "
              f"{launched}; expected {want} (fwd, dq, dkv over {steps} "
              f"steps)")
        timed = res["step_losses"]
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(timed, lm7["step_losses"]))
        check(rel <= LM_SP_LOSS_RTOL, f"phase 12 remat={remat} losses "
              f"{timed} vs phase 7's {lm7['step_losses']}: worst relative "
              f"difference {rel:.3g} > {LM_SP_LOSS_RTOL}")
        print(f"phase 12 (b) LM d{LM['d_model']}/L{LM['n_layers']}/"
              f"H{LM['n_heads']} T {LM['seq_len']} B {LM['batch_size']} "
              f"flash remat={remat}: {res['tok_sec_per_chip']:,.0f} +-"
              f"{res['tok_sec_conf']:,.0f} tok/s, {res['ms_per_step']:.2f} "
              f"ms/step, peak {res['max_memory_allocated']} bytes (phase "
              f"7, remat=none: {lm7['tok_sec_per_chip']:,.0f} tok/s, "
              f"{lm7['ms_per_step']:.2f} ms/step, peak "
              f"{lm7['max_memory_allocated']} bytes) on {smi}; timed "
              f"losses equal to phase 7's bit for bit: "
              f"{timed == lm7['step_losses']} (worst relative difference "
              f"{rel:.3g}); flash launches fwd/dq/dkv {launched} = "
              f"{REMAT_FWD_PER_LAYER[remat]}/1/1 per layer and step",
              flush=True)
        del res
    torch.cuda.empty_cache()
    return path


def _pipeline_peak_reckoning(cfg, batch: int, m: int, n_stages: int,
                             schedule: str) -> int:
    """Bytes the pipelined step should need at its peak on one card with
    every pipe rank on it: f32 parameters and their stacked copies, two
    f32 gradient sets (the accumulated and the replayed), the bf16
    momentum, and per live microbatch and layer the saved activations of
    the local-attention layer (bf16 probabilities [mb, H, T, T], the
    layer's bf16 weight casts, the MLP's [mb, T, d_ff] pair, q/k/v/o and
    the f32 RMSNorm rows), plus each rank's logits head ([B, T, V] f32
    logits, log-softmax and their gradient).  GPipe keeps all M
    microbatches of every layer; 1F1B one stage's recompute a rank."""
    d, f, v, n, t = (cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers,
                     cfg.max_seq)
    mb = batch // m
    layer_params = 4 * d * d + 2 * d * f + 2 * d
    base = v * d + t * d + d
    params = 4 * (n * layer_params + n_stages * base)
    state = params + 4 * n * layer_params + 2 * params + params // 2
    act = (2 * mb * cfg.n_heads * t * t + 2 * layer_params +
           2 * 2 * mb * t * f + 4 * 2 * mb * t * d + 3 * 4 * mb * t * d)
    live = n * m if schedule in ("gpipe", "interleaved") else n
    head = n_stages * 3 * 4 * batch * t * v
    return state + act * live + head


def _stage_of(name: str, n_layers: int, n_stages: int, virtual: int):
    """Which pipe rank holds a plain LM leaf, and its PipelineLM name."""
    if not name.startswith("layers."):
        return 0, name
    _, j, leaf = name.split(".")
    lpc = n_layers // (n_stages * virtual)
    c, i = divmod(int(j), lpc)
    p, k = (c % n_stages, c // n_stages) if virtual > 1 else (c, 0)
    return p, f"chunks.{k}.{i}.{leaf}"


def phase_pipeline(smi: str, device="cuda", lm=None,
                   microbatches: int = PP_MICROBATCHES,
                   virtual: int = PP_VIRTUAL, steps: int = PP_STEPS) -> dict:
    """Phase 12 (c): the LM on a 1 x 2 (data x pipe) mesh of 2 virtual
    ranks under every schedule, held to the plain local-attention step on
    the same batch and weights.  Returns the schedules' results."""
    from horovod_tpu_torch.benchmark import make_lm_bench_state
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.optim import SGD
    from horovod_tpu_torch.parallel.sequence import VirtualAxis

    on_card = torch.device(device).type == "cuda"
    lm = dict(lm or LM)
    n_stages = 2

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def reset():
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() if on_card else None

    reset()
    st = make_lm_bench_state(lm["d_model"], lm["n_layers"], lm["n_heads"],
                             lm["d_ff"], lm["vocab_size"], lm["seq_len"],
                             lm["batch_size"], momentum_dtype="bfloat16",
                             device=None if on_card else device)
    cfg, device = st.cfg, st.mesh.device
    init = {k: v.detach().to("cpu", copy=True)
            for k, v in st.model.state_dict().items()}
    step = tfm.make_train_step(st.model, st.optimizer, st.mesh, st.axis,
                               attention="local")
    plain_losses, plain_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        plain_losses.append(float(step(st.tokens, st.labels)))
        sync()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    plain_peak = peak()
    du_plain = {k: v.detach().cpu() - init[k]
                for k, v in st.model.state_dict().items()}
    tokens, labels, mesh = st.tokens, st.labels, st.mesh
    del st, step
    reset()
    tree = {k: init[k] for k in ("embed", "pos", "ln_f_scale")}
    tree["layers"] = [{leaf: init[f"layers.{i}.{leaf}"]
                       for leaf in tfm.LAYER_LEAVES}
                      for i in range(cfg.n_layers)]
    print(f"phase 12 (c) plain step (attention=local) on the LM "
          f"d{cfg.d_model}/L{cfg.n_layers}/H{cfg.n_heads} T "
          f"{cfg.max_seq} B {lm['batch_size']} {str(cfg.dtype)[6:]}: "
          f"losses {plain_losses}, ms per step {plain_ms}, peak "
          f"{plain_peak} bytes on {smi}", flush=True)
    results = {}
    for schedule in tfm.PIPELINE_SCHEDULES:
        v = virtual if schedule.startswith("interleaved") else 1
        split = tfm.split_pipeline_params(tree, n_stages, v)

        def rank(r, v=v, schedule=schedule, split=split):
            model = tfm.PipelineLM(cfg, n_stages, r.index, v, device=device)
            model.load_state_dict(convert.lm_pipeline_to_rank(
                split, r.index, v))
            opt = SGD([p for _, p in
                       convert.lm_pipeline_ordered_parameters(model)],
                      1e-4, 0.9, torch.bfloat16)
            pstep = tfm.make_train_step_pipelined(
                model, opt, mesh, "data", r, n_microbatches=microbatches,
                schedule=schedule, virtual=v)
            losses, ms = [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                losses.append(float(pstep(tokens, labels)))
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
            return losses, ms, {k: x.detach().cpu()
                                for k, x in model.state_dict().items()}

        reset()
        out = VirtualAxis(n_stages).run(rank)
        pk = peak()
        del split
        losses, ms = out[0][0], out[0][1]
        check(all(o[0] == losses for o in out), f"phase 12 {schedule}: the "
              f"pipe ranks disagree on the loss: {[o[0] for o in out]}")
        check(all(x == x and abs(x) != float("inf") for x in losses),
              f"phase 12 {schedule} losses not finite: {losses}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
        check(rel <= LM_PP_LOSS_RTOL, f"phase 12 {schedule} losses {losses}"
              f" vs the plain step's {plain_losses}: worst relative "
              f"difference {rel:.3g} > {LM_PP_LOSS_RTOL}")
        if "gpipe" in results:
            g = results["gpipe"]["losses"]
            rel_g = max(abs(a - b) / abs(b) for a, b in zip(losses, g))
            check(rel_g <= LM_PP_LOSS_RTOL, f"phase 12 {schedule} losses "
                  f"{losses} vs gpipe's {g}: {rel_g:.3g} > "
                  f"{LM_PP_LOSS_RTOL}")
        worst = ("", 0.0)
        for name, du in du_plain.items():
            p, local = _stage_of(name, cfg.n_layers, n_stages, v)
            du_pp = out[p][2][local] - init[name]
            err = ((du_pp - du).norm() / du.norm().clamp_min(1e-30)).item()
            if err > worst[1]:
                worst = (name, err)
        check(worst[1] <= LM_PP_UPDATE_TOL, f"phase 12 {schedule}: update "
              f"of {worst[0]} differs from the plain step's by "
              f"{worst[1]:.3g} > {LM_PP_UPDATE_TOL}")
        base_gap = max((out[0][2][k] - out[1][2][k]).abs().max().item()
                       for k in ("embed", "pos", "ln_f_scale"))
        reckoned = _pipeline_peak_reckoning(cfg, lm["batch_size"],
                                            microbatches, n_stages, schedule)
        results[schedule] = {"losses": losses, "ms": ms, "peak": pk,
                             "reckoned_peak": reckoned,
                             "worst_update": worst, "loss_rel": rel}
        print(f"phase 12 (c) {schedule} (P {n_stages} virtual ranks, M "
              f"{microbatches}, {cfg.n_layers // (n_stages * v)} layer(s) a "
              f"chunk, {v} chunk(s) a rank): losses {losses} (worst "
              f"relative difference from the plain step's {rel:.3g}, "
              f"tolerance {LM_PP_LOSS_RTOL}); worst leaf update "
              f"{worst[0]} {worst[1]:.3g} (tolerance {LM_PP_UPDATE_TOL}); "
              f"base leaves across pipe ranks max abs {base_gap:.3g}; ms "
              f"per step {ms} (plain: {plain_ms}); peak {pk} bytes "
              f"(reckoned {reckoned}; plain {plain_peak}) on {smi}",
              flush=True)
        del out
    reset()
    return results


def _pipeline_step_worker(rank, size, addr, backend, shape, out_dir):
    import os

    import numpy as np

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.optim import SGD
    from horovod_tpu_torch.topology import build_mesh

    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=addr)
    hvd.init(device=None if backend == "nccl" else "cpu")
    try:
        mesh = build_mesh(axes=("data", "pipe"), shape=shape)
        cfg = tfm.TransformerConfig(**PP_STEP_LM, dtype=torch.bfloat16)
        tree = _small_lm_tree(cfg, 11)
        ttree = {k: (torch.from_numpy(np.asarray(x, np.float32))
                     if k != "layers" else
                     [{a: torch.from_numpy(np.asarray(w, np.float32))
                       for a, w in layer.items()} for layer in x])
                 for k, x in tree.items()}
        t = cfg.max_seq
        toks = np.random.default_rng(12).integers(
            0, cfg.vocab_size, (PP_STEP_BATCH * shape[0], t + 1))
        d, p = mesh.axis_index("data"), mesh.axis_index("pipe")
        rows = slice(d * PP_STEP_BATCH, (d + 1) * PP_STEP_BATCH)
        tokens = torch.from_numpy(toks[rows, :-1].copy()).to(mesh.device)
        labels = torch.from_numpy(toks[rows, 1:].copy()).to(mesh.device)
        out = {"init": {}}
        for schedule in tfm.PIPELINE_SCHEDULES:
            v = PP_STEP_VIRTUAL if schedule.startswith("interleaved") else 1
            split = tfm.split_pipeline_params(ttree, shape[1], v)
            model = tfm.PipelineLM(cfg, shape[1], p, v, device=mesh.device)
            model.load_state_dict(convert.lm_pipeline_to_rank(split, p, v))
            opt = SGD([x for _, x in
                       convert.lm_pipeline_ordered_parameters(model)],
                      0.1, momentum=0.9)
            step = tfm.make_train_step_pipelined(
                model, opt, mesh, "data", "pipe",
                n_microbatches=PP_STEP_MICROBATCHES, schedule=schedule,
                virtual=v)
            losses = [float(step(tokens, labels)) for _ in range(2)]
            out[schedule] = {"losses": losses,
                             "params": convert.lm_rank_to_pipeline(
                                 model.state_dict(), mesh.axis("pipe"), v)}
            out["init"][schedule] = {
                "base": {k: np.asarray(x) for k, x in tree.items()
                         if k != "layers"},
                "stacked": {k: x.numpy() for k, x in
                            split["stacked"].items()}}
        torch.save(out, f"{out_dir}/pp_{backend}{rank}.pt")
    finally:
        hvd.shutdown()


def run_pipeline_lm_step(backend: str, shape, out_dir: str) -> list:
    """Two DP x PP steps of every schedule of a small bf16 pipelined LM on
    a (data, pipe) mesh of ``shape`` over ``backend`` (NCCL: one card a
    rank; gloo: the CPU); each rank's losses and gathered parameters."""
    import math
    size = math.prod(shape)
    _spawn(_pipeline_step_worker, size, (backend, tuple(shape)), out_dir)
    return [torch.load(f"{out_dir}/pp_{backend}{r}.pt", weights_only=False)
            for r in range(size)]


def compare_pipeline_lm_step(nccl: list, gloo: list) -> dict:
    """Per schedule, the worst loss difference (relative) and the worst
    leaf's update difference ``||du_nccl - du_gloo|| / ||du_gloo||`` over
    every rank, checked against SP_STEP_LOSS_RTOL and
    SP_STEP_UPDATE_TOL."""
    import numpy as np

    out = {}
    for schedule in nccl[0]:
        if schedule == "init":
            continue
        worst_loss, worst_update = 0.0, ("", 0.0)
        for a, b in zip(nccl, gloo):
            for x, y in zip(a[schedule]["losses"], b[schedule]["losses"]):
                worst_loss = max(worst_loss, abs(x - y) / abs(y))
            init = a["init"][schedule]
            for group in ("base", "stacked"):
                for name, pa in a[schedule]["params"][group].items():
                    w0 = np.asarray(init[group][name], np.float32)
                    ua = pa - w0
                    ub = b[schedule]["params"][group][name] - w0
                    err = float(np.linalg.norm(ua - ub) /
                                max(np.linalg.norm(ub), 1e-30))
                    if err > worst_update[1]:
                        worst_update = (f"{group}.{name}", err)
        check(worst_loss <= SP_STEP_LOSS_RTOL, f"pipelined LM step "
              f"{schedule} losses nccl vs gloo: {worst_loss:.3g} > "
              f"{SP_STEP_LOSS_RTOL}")
        check(worst_update[1] <= SP_STEP_UPDATE_TOL, f"pipelined LM step "
              f"{schedule} updates nccl vs gloo: {worst_update} > "
              f"{SP_STEP_UPDATE_TOL}")
        out[schedule] = {"loss_rel": worst_loss,
                         "update_leaf": worst_update[0],
                         "update_rel": worst_update[1]}
    return out


def phase_pipeline_processes(smi: str) -> None:
    """Phase 12 (d): the pipelined step across NCCL processes, where the
    host has the cards for it."""
    import tempfile

    n = torch.cuda.device_count()
    if n < 2:
        print(f"phase 12 (d) did not run: {n} CUDA device here, and the "
              f"dp x pp step across NCCL processes needs one card a rank "
              f"(2 for a 1x2 (data, pipe) mesh, 4 for 2x2; NCCL refuses "
              f"two ranks on one card)", flush=True)
        return
    shape = (2, 2) if n >= 4 else (1, 2)
    with tempfile.TemporaryDirectory() as out:
        nccl = run_pipeline_lm_step("nccl", shape, out)
        gloo = run_pipeline_lm_step("gloo", shape, out)
    res = compare_pipeline_lm_step(nccl, gloo)
    print(f"phase 12 (d): two dp x pp steps of every schedule of a small "
          f"bf16 pipelined LM on a {shape} (data, pipe) mesh over NCCL ({n} "
          f"cards: {smi}) against gloo on the CPU: " + json.dumps(res),
          flush=True)


def _zero_plan(codec: str):
    """The LM of record's reduce-scatter plan at one rank under ``codec``
    (meta tensors: no memory), the logical wire bytes a step that plan
    reckons, and the collectives a step launches: (reduce-scatters,
    all-gathers, all-to-alls)."""
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import compression as C
    from horovod_tpu_torch.ops import fusion

    cfg = tfm.TransformerConfig(
        **{k: v for k, v in LM.items() if k not in ("seq_len",
                                                    "batch_size")},
        max_seq=LM["seq_len"])
    model = tfm.TransformerLM(cfg, device="meta")
    leaves = [p for _, p in convert.lm_ordered_parameters(model)]
    c = C.resolve_codec(codec)
    plan = fusion.make_reduce_scatter_plan(leaves, 1, codec=c)
    nb = len(plan.buckets)
    padded = [plan.padded_size(b) for b in range(nb)]
    if c.name == "none":
        wire, calls = 8 * sum(padded), (nb, nb, 0)
    elif c.name == "bf16":
        wire, calls = 4 * sum(padded), (nb, nb, 0)
    elif c.name == "int8":
        wire, calls = 2 * sum(padded) + 16 * nb, (0, 3 * nb, nb)
    else:
        low = set(plan.lowrank)
        rs = sum(2 * padded[b] if b not in low else
                 sum(plan.bucket_leaf_shape(b)) * c.rank * 4
                 for b in range(nb))
        wire, calls = rs + 2 * sum(padded), (nb - len(low), nb, 0)
    return plan, wire, calls


def phase_zero(smi: str, lm7: dict) -> list:
    """Phase 13 (a): the LM of record's ZeRO-1 step under every codec.
    Returns the flash launches of its runs."""
    from horovod_tpu_torch.benchmark import run_lm_benchmark
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fusion

    flash = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    colls = (fusion.reduce_scatter_calls, fusion.all_gather_calls,
             fusion.all_to_all_calls)
    steps = LM_WARMUP_STEPS + ZERO_TIMED_STEPS
    path = [0, 0, 0]
    rows = {}
    for codec in ZERO_CODECS:
        plan, wire_want, calls_want = _zero_plan(codec)
        torch.cuda.empty_cache()
        for c in flash + colls:
            c.reset()
        res = run_lm_benchmark(
            **LM, attention="flash", remat="none", momentum_dtype="bfloat16",
            num_warmup_batches=LM_WARMUP_STEPS, num_batches_per_iter=1,
            num_iters=ZERO_TIMED_STEPS, shard_optimizer=True,
            compression=codec, verbose=False)
        launched = [c.count for c in flash]
        calls = [c.count for c in colls]
        path = [a + x for a, x in zip(path, launched)]
        n = LM["n_layers"] * steps
        check(launched == [n, n, n], f"phase 13 {codec} flash launches "
              f"{launched}; expected {n} each ({steps} steps)")
        check(calls == [k * steps for k in calls_want],
              f"phase 13 {codec} (reduce-scatter, all-gather, all-to-all) "
              f"calls {calls}; the plan's {len(plan.buckets)} buckets give "
              f"{calls_want} a step over {steps} steps")
        losses = res["step_losses"]
        for i, loss in enumerate(losses):
            check(loss == loss and abs(loss) != float("inf"),
                  f"phase 13 {codec} step {i} loss is not finite: {loss}")
        check(res["wire_bytes_per_step"] == wire_want,
              f"phase 13 {codec} wire bytes a step "
              f"{res['wire_bytes_per_step']} != the plan's {wire_want}")
        rows[codec] = res
        print(f"phase 13 (a) LM d{LM['d_model']}/L{LM['n_layers']}/"
              f"H{LM['n_heads']} T {LM['seq_len']} B {LM['batch_size']} "
              f"flash ZeRO-1 compression={codec}: "
              f"{res['tok_sec_per_chip']:,.0f} +-{res['tok_sec_conf']:,.0f} "
              f"tok/s, {res['ms_per_step']:.2f} ms/step, peak "
              f"{res['max_memory_allocated']} bytes (phase 7: "
              f"{lm7['tok_sec_per_chip']:,.0f} tok/s, "
              f"{lm7['ms_per_step']:.2f} ms/step, peak "
              f"{lm7['max_memory_allocated']} bytes) on {smi}; per step "
              f"{calls[0] // steps} reduce-scatters, {calls[1] // steps} "
              f"all-gathers, {calls[2] // steps} all-to-alls over the "
              f"plan's {len(plan.buckets)} buckets ({len(plan.lowrank)} "
              f"low-rank); flash launches {launched} = 10 a step each; "
              f"optimizer state {res['optimizer_state_bytes']} bytes a "
              f"rank; wire {res['wire_bytes_per_step']:.0f} bytes a step; "
              f"timed losses {losses[0]:.6f} -> {losses[-1]:.6f}",
              flush=True)
        del res
    none = rows["none"]["step_losses"]
    equal = none[:LM_TIMED_STEPS] == lm7["step_losses"]
    check(equal, f"phase 13 none's losses {none[:LM_TIMED_STEPS]} are not "
          f"phase 7's {lm7['step_losses']} bit for bit")
    a, b = ZERO_LOSS_BOUND
    base_wire = rows["none"]["wire_bytes_per_step"]
    summary = {}
    for codec, res in rows.items():
        worst = max(abs(x - y) - (a * abs(x) + b) for x, y in
                    zip(none[2:], res["step_losses"][2:]))
        check(worst <= 0, f"phase 13 {codec} losses "
              f"{res['step_losses']} leave none's {none} by {worst:.3g} "
              f"beyond {a}|none| + {b}")
        ratio = res["wire_bytes_per_step"] / base_wire
        if codec == "int8":
            check(abs(ratio - INT8_WIRE_RATIO[0]) <= INT8_WIRE_RATIO[1],
                  f"phase 13 int8 wire ratio {ratio}")
        if codec == "bf16":
            check(ratio == 0.5, f"phase 13 bf16 wire ratio {ratio}")
        summary[codec] = {
            "ms_per_step": res["ms_per_step"],
            "tok_sec_per_chip": res["tok_sec_per_chip"],
            "max_memory_allocated": res["max_memory_allocated"],
            "optimizer_state_bytes": res["optimizer_state_bytes"],
            "wire_bytes_per_step": res["wire_bytes_per_step"],
            "wire_ratio": ratio,
            "loss_first_last": [res["step_losses"][0],
                                res["step_losses"][-1]]}
    print(f"phase 13 (a): none's first {LM_TIMED_STEPS} timed losses equal "
          f"phase 7's bit for bit: {equal}; every codec within "
          f"{a}|none| + {b} from the third timed step; " +
          json.dumps(summary), flush=True)
    torch.cuda.empty_cache()
    return path


def _zero_step_worker(rank, size, addr, backend, shape, out_dir):
    import os

    import numpy as np
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import compression as C
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.optim import SGD
    from horovod_tpu_torch.topology import build_mesh

    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=addr)
    hvd.init(device=None if backend == "nccl" else "cpu")
    try:
        dev = hvd.mesh().device
        cfg = tfm.TransformerConfig(**SP_STEP_LM, dtype=torch.bfloat16)
        tree = _small_lm_tree(cfg, 13)
        t = cfg.max_seq
        toks = np.random.default_rng(14).integers(
            0, cfg.vocab_size, (SP_STEP_BATCH * size, t + 1))
        rows = slice(rank * SP_STEP_BATCH, (rank + 1) * SP_STEP_BATCH)
        tokens = torch.from_numpy(toks[rows, :-1].copy()).to(dev)
        labels = torch.from_numpy(toks[rows, 1:].copy()).to(dev)
        out = {"init": tree}
        for codec in ZERO_STEP_CODECS:
            model = tfm.TransformerLM(cfg, device=dev)
            model.load_state_dict(convert.lm_params_to_torch(tree))
            opt = SGD([p for _, p in convert.lm_ordered_parameters(model)],
                      0.1, momentum=0.9, accumulator_dtype=torch.bfloat16)
            step = tfm.make_train_step(model, opt, hvd.mesh(),
                                       attention="flash",
                                       shard_optimizer=True,
                                       compression=codec)
            losses = [float(step(tokens, labels)) for _ in range(2)]
            out[codec] = {"losses": losses,
                          "params": convert.lm_state_dict_to_params(
                              {k: v.float().cpu() for k, v in
                               model.state_dict().items()})}
        # Two levels on a (dcn, ici) mesh, on a 2^-3 grid (exact sums).
        mesh = build_mesh(axes=("dcn", "ici"), shape=shape)
        ici, dcn = mesh.axis("ici"), mesh.axis("dcn")
        g = np.random.default_rng(15 + rank)
        leaves = [torch.from_numpy(np.round(g.standard_normal(s) * 8) / 8)
                  .float().to(dev) for s in ((33, 7), (129,), (5,))]
        shards, plan = fusion.fused_hierarchical_reduce_scatter(
            leaves, ici, dcn, threshold=256)
        hier = fusion.fused_all_gather(shards, plan, ici)
        flat = fusion.fused_pytree_mean(leaves)
        out["hier"] = [h.cpu() for h in hier]
        out["hier_equal_flat"] = all(torch.equal(h, f)
                                     for h, f in zip(hier, flat))
        x = leaves[1]
        want = x.clone()
        dist.all_reduce(want, group=dcn)
        # int8's code step: the shared scale, absmax over dcn / 127.
        step = x.abs().max().float()
        dist.all_reduce(step, op=dist.ReduceOp.MAX, group=dcn)
        out["cross_int8_step"] = float(step) / 127
        out["cross"] = {spec: C.cross_level_psum(x, dcn, spec).cpu()
                        for spec in ("none", "bf16", "fp16", "int8")}
        out["cross_flat"] = want.cpu()
        torch.save(out, f"{out_dir}/zero_{backend}{rank}.pt")
    finally:
        hvd.shutdown()


def run_zero_step(backend: str, shape, out_dir: str) -> list:
    """Phase 13 (b)'s program on ``prod(shape)`` ranks over ``backend``
    (NCCL: one card a rank; gloo: the CPU)."""
    import math
    size = math.prod(shape)
    _spawn(_zero_step_worker, size, (backend, tuple(shape)), out_dir)
    return [torch.load(f"{out_dir}/zero_{backend}{r}.pt", weights_only=False)
            for r in range(size)]


def _leaf_updates(out: dict, codec: str) -> dict:
    """Each leaf's update ``params - init`` of one rank's run of
    ``codec`` in phase 13 (b), by dotted name."""
    import numpy as np

    init, params = out["init"], out[codec]["params"]
    names = [(key, init[key], params[key])
             for key in ("embed", "pos", "ln_f_scale")]
    for i, layer in enumerate(params["layers"]):
        names += [(f"layers.{i}.{key}", init["layers"][i][key], w)
                  for key, w in layer.items()]
    return {name: w - np.asarray(w0, np.float32) for name, w0, w in names}


def compare_zero_step(nccl: list, gloo: list) -> dict:
    """Per codec, the worst loss difference (relative) and the worst
    leaf's update difference ``||du_nccl - du_gloo|| / ||du_gloo||`` over
    every rank, held as phase 11 (c).  Under int8 a leaf's update also
    carries the codec's quantization noise, which the two backends'
    slightly different gradients realize differently: a leaf of small
    gradients in a bucket of large ones reads 0.3 of its update between
    int8 and none on the same ranks.  So an int8 leaf may differ by
    SP_STEP_UPDATE_TOL plus twice that leaf's own int8-against-none
    difference on the gloo ranks (two realizations of the noise); a
    misrouted shard would read O(1) on the large leaves.  The two-level
    collectives equal to the flat ones on every backend, NCCL's equal to
    gloo's, and cross_level_psum's none to the flat sum, bitwise (int8
    within one code step a rank)."""
    import numpy as np

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    out = {}
    for codec in ZERO_STEP_CODECS:
        worst_loss, worst_update = 0.0, None
        for a, b in zip(nccl, gloo):
            for x, y in zip(a[codec]["losses"], b[codec]["losses"]):
                worst_loss = max(worst_loss, abs(x - y) / abs(y))
            ua, ub = _leaf_updates(a, codec), _leaf_updates(b, codec)
            noise = ({k: rel(v, u) for (k, v), u in zip(
                ub.items(), _leaf_updates(b, "none").values())}
                if codec != "none" else {k: 0.0 for k in ub})
            for name in ub:
                err = rel(ua[name], ub[name])
                limit = SP_STEP_UPDATE_TOL + 2 * noise[name]
                if (worst_update is None
                        or err - limit > worst_update[1] - worst_update[2]):
                    worst_update = (name, err, limit)
        check(worst_loss <= SP_STEP_LOSS_RTOL, f"ZeRO LM step {codec} "
              f"losses nccl vs gloo: {worst_loss:.3g} > {SP_STEP_LOSS_RTOL}")
        check(worst_update[1] <= worst_update[2], f"ZeRO LM step {codec} "
              f"updates nccl vs gloo (leaf, difference, limit): "
              f"{worst_update}")
        out[codec] = {"loss_rel": worst_loss,
                      "update_leaf": worst_update[0],
                      "update_rel": worst_update[1],
                      "update_limit": worst_update[2]}
    for a, b in zip(nccl, gloo):
        check(a["hier_equal_flat"] and b["hier_equal_flat"],
              "two-level reduce-scatter is not the flat mean")
        check(all(torch.equal(x, y) for x, y in zip(a["hier"], b["hier"])),
              "two-level reduce-scatter: NCCL differs from gloo")
        check(torch.equal(a["cross"]["none"], a["cross_flat"]),
              "cross_level_psum none is not the flat sum")
        for spec, got in a["cross"].items():
            # int8: a quotient x / scale that lies within rounding of a
            # half may take the other code on the card than on the CPU:
            # at most one code step for each of the dcn ranks.
            diff = float((got - b["cross"][spec]).abs().max())
            tol = (len(nccl) * a["cross_int8_step"] if spec == "int8"
                   else 0.0)
            check(diff <= tol, f"cross_level_psum {spec}: NCCL differs "
                  f"from gloo by {diff} > {tol}")
            out[f"cross_{spec}_max_diff"] = max(
                out.get(f"cross_{spec}_max_diff", 0.0), diff)
    out["two_level"] = "equal to the flat collectives"
    return out


def phase_zero_processes(smi: str) -> None:
    """Phase 13 (b): the ZeRO step and the two-level collectives across
    NCCL processes, where the host has the cards for it."""
    import tempfile

    n = torch.cuda.device_count()
    if n < 2:
        print(f"phase 13 (b) did not run: {n} CUDA device here, and the "
              f"ZeRO step across NCCL processes needs one card a rank (2 "
              f"for a 1x2 (dcn, ici) mesh, 4 for 2x2; NCCL refuses two "
              f"ranks on one card)", flush=True)
        return
    shape = (2, 2) if n >= 4 else (1, 2)
    with tempfile.TemporaryDirectory() as out:
        nccl = run_zero_step("nccl", shape, out)
        gloo = run_zero_step("gloo", shape, out)
    res = compare_zero_step(nccl, gloo)
    print(f"phase 13 (b): two ZeRO steps of a small bf16 LM under "
          f"{ZERO_STEP_CODECS} and the two-level collectives on a {shape} "
          f"(dcn, ici) mesh over NCCL ({n} cards: {smi}) against gloo on "
          f"the CPU: " + json.dumps(res), flush=True)


# ---------------------------------------------------------------------------
# Phase 14: expert parallelism, the resilience ladder and checkpoints
# ---------------------------------------------------------------------------

def _moe_expert(p, tok):
    """One rank's expert: the LM's MLP, f32 params, bf16 compute."""
    import torch.nn.functional as F

    h = F.gelu(tok.to(torch.bfloat16) @ p["w1"].to(torch.bfloat16),
               approximate="tanh")
    return (h @ p["w2"].to(torch.bfloat16)).float()


def _moe_inputs(d, h, t, device, seed, n=MOE_RANKS):
    """x [S, t, d] bf16, router [d, S], w1 [S, d, h], w2 [S, h, d] (f32),
    the cotangent ct [S, t, d] f32, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    router = draw(d, n, scale=d ** -0.5)
    router[:, 0] *= MOE_ROUTER_SKEW
    return {"x": draw(n, t, d).to(torch.bfloat16), "router": router,
            "w1": draw(n, d, h, scale=d ** -0.5),
            "w2": draw(n, h, d, scale=h ** -0.5), "ct": draw(n, t, d)}


def _moe_leaves(inp):
    """Per rank: its tokens, its copy of the router, its expert."""
    return [{"x": inp["x"][r].clone().requires_grad_(),
             "router": inp["router"].clone().requires_grad_(),
             "w1": inp["w1"][r].clone().requires_grad_(),
             "w2": inp["w2"][r].clone().requires_grad_()}
            for r in range(MOE_RANKS)]


def _moe_grads(ys, leaves, ct):
    """The gradients of sum_r (y_r * ct_r) for every rank's leaves, one
    backward over every rank's output; the router's summed over ranks."""
    loss = sum((y.float() * ct[r]).sum() for r, y in enumerate(ys))
    keys = ("x", "router", "w1", "w2")
    flat = torch.autograd.grad(loss, [lv[k] for lv in leaves for k in keys])
    g = {k: torch.stack(flat[i::len(keys)]) for i, k in enumerate(keys)}
    g["router"] = g["router"].sum(0)
    return g


def _moe_layer_run(variant, inp):
    """One forward and backward of ``variant`` on MOE_RANKS virtual ranks
    on the inputs' device: (y [S, t, d], gradients, share dropped)."""
    from horovod_tpu_torch.parallel import expert as ep
    from horovod_tpu_torch.parallel import sequence as sq

    _, layer, router, cf = variant
    leaves = _moe_leaves(inp)

    def rank(ax):
        lv = leaves[ax.index]
        p = {"w1": lv["w1"], "w2": lv["w2"]}
        if layer == "dense":
            return ep.moe_layer(lv["x"], lv["router"], _moe_expert, p, ax,
                                cf, router=router)
        return ep.moe_layer_ragged(lv["x"], lv["router"], _moe_expert, p,
                                   ax, cf)

    ys = sq.VirtualAxis(MOE_RANKS).run(rank)
    grads = _moe_grads(ys, leaves, inp["ct"])
    y = torch.stack([v.detach() for v in ys])
    dropped = (y.float().abs().sum(-1) == 0).float().mean().item()
    return y, grads, dropped


def _plain_routes(logits, router: str, capacity: int):
    """Routing written out with torch's own softmax, argmax and cumsum:
    for each choice (one for top-1, two for top-2), each token's expert
    [t], gate [t] and whether it found room in the expert's dense buffer
    of ``capacity`` slots (every first choice queues before any second)."""
    import torch.nn.functional as F

    probs = torch.softmax(logits, dim=-1)
    e = probs.shape[-1]
    i1 = probs.argmax(-1)
    p1 = probs.gather(1, i1[:, None])[:, 0]
    oh1 = F.one_hot(i1, e)
    pos1 = (oh1.cumsum(0) * oh1).sum(-1) - 1
    if router == "top1":
        return [(i1, p1, pos1 < capacity)]
    masked = probs * (1.0 - oh1.float())
    i2 = masked.argmax(-1)
    p2 = masked.gather(1, i2[:, None])[:, 0]
    oh2 = F.one_hot(i2, e)
    pos2 = ((oh2.cumsum(0) + oh1.sum(0)) * oh2).sum(-1) - 1
    denom = p1 + p2 + 1e-9
    return [(i1, p1 / denom, pos1 < capacity),
            (i2, p2 / denom, pos2 < capacity)]


def _moe_oracle(variant, inp):
    """The same layer in one process with no dispatch, buffers or
    exchange, and with routing of its own (:func:`_plain_routes`, not the
    port's): each token's output is its kept choices' gate-weighted
    experts' outputs; the ragged layer's buffer of S·capacity rows is
    granted to source ranks in rank order.  Returns (y, gradients, share
    of the routed choices that capacity dropped)."""
    _, layer, router, cf = variant
    n = MOE_RANKS
    leaves = _moe_leaves(inp)
    t = inp["x"].shape[1]
    capacity = max(int(cf * t / n), 1)
    logits = [lv["x"].float() @ lv["router"] for lv in leaves]
    experts = [{"w1": lv["w1"], "w2": lv["w2"]} for lv in leaves]
    ys = []
    if layer == "dense":
        kept = 0.0
        for r, lv in enumerate(leaves):
            outs = [_moe_expert(experts[e], lv["x"]) for e in range(n)]
            y = 0.0
            for idx, gate, room in _plain_routes(logits[r], router,
                                                 capacity):
                kept += room.sum().item()
                for e in range(n):
                    w = torch.where(room & (idx == e), gate, 0.0)
                    y = y + w[:, None] * outs[e]
            ys.append(y)
        choices = n * t * (1 if router == "top1" else 2)
        return (torch.stack([y.detach() for y in ys]),
                _moe_grads(ys, leaves, inp["ct"]), 1 - kept / choices)
    routes = [_plain_routes(lg, "top1", capacity)[0] for lg in logits]
    dest = torch.stack([idx for idx, _, _ in routes])          # [S, t]
    buf = n * capacity
    kept = torch.zeros_like(dest, dtype=torch.bool)
    for j in range(n):
        mine = dest == j
        order = torch.cumsum(mine.reshape(-1).long(), 0).reshape(dest.shape)
        kept |= mine & (order <= buf)
    for r, lv in enumerate(leaves):
        gate = routes[r][1]
        out = torch.zeros_like(lv["x"])
        for e in range(n):
            rows = kept[r] & (dest[r] == e)
            out = out + torch.where(rows[:, None], _moe_expert(
                experts[e], lv["x"]).to(lv["x"].dtype), 0.0)
        ys.append(out * gate[:, None].to(lv["x"].dtype))
    return (torch.stack([y.detach() for y in ys]),
            _moe_grads(ys, leaves, inp["ct"]),
            1 - kept.float().mean().item())


def _routing_on_card_is_cpus(inp) -> None:
    """The port's routers on the card against the same calls on the CPU,
    bit for bit, on rank 0's logits at full width (the first
    MOE_ROUTE_TOKENS tokens): the CPU's are held to JAX's in the tests,
    and the card runs the same f32 arithmetic."""
    from horovod_tpu_torch.parallel import expert as ep

    x = inp["x"][0][:MOE_ROUTE_TOKENS]
    logits = ep._matmul(x, inp["router"])
    for route, cf in ((ep.top1_routing, 1.25), (ep.top2_routing, 2.5)):
        capacity = max(int(cf * MOE_ROUTE_TOKENS / MOE_RANKS), 1)
        got = route(logits, capacity)
        want = route(logits.cpu(), capacity)
        same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        check(same, f"phase 14 (a) {route.__name__} on the card is not "
              f"the CPU's bit for bit")


def _grad_rel(a, b) -> dict:
    return {k: ((a[k].float() - b[k].float()).norm()
                / b[k].float().norm()).item() for k in b}


def _phase_moe(smi: str) -> None:
    """Phase 14 (a)."""
    d, f = LM["d_model"], LM["d_ff"]
    t = LM["batch_size"] * LM["seq_len"]
    small = {k: v.cpu() for k, v in _moe_inputs(
        MOE_SMALL["d"], MOE_SMALL["h"], MOE_SMALL["t"], "cpu", 41).items()}
    for variant in MOE_VARIANTS:
        label = variant[0]
        # The card against CPU threads at a small width.
        gpu_small = _moe_layer_run(variant, {k: v.cuda()
                                             for k, v in small.items()})
        cpu_small = _moe_layer_run(variant, small)
        ratio = _row_ratio(gpu_small[0].cpu(), cpu_small[0])
        rel = _grad_rel({k: v.cpu() for k, v in gpu_small[1].items()},
                        cpu_small[1])
        check(ratio <= 1 and max(rel.values()) <= MOE_GRAD_TOL,
              f"phase 14 (a) {label} at d{MOE_SMALL['d']}: the card against "
              f"CPU threads, row ratio {ratio:.3g}, gradients {rel}")
        # Full width: against the one-process oracle, then timed.
        inp = _moe_inputs(d, f, t, "cuda", 42)
        if variant is MOE_VARIANTS[0]:
            _routing_on_card_is_cpus(inp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        y, grads, dropped = _moe_layer_run(variant, inp)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        y_ref, g_ref, dropped_choices = _moe_oracle(variant, inp)
        row = _row_ratio(y, y_ref)
        grel = _grad_rel(grads, g_ref)
        check(row <= 1, f"phase 14 (a) {label}: worst row at {row:.3g} of "
              f"phase 6's limit against the oracle")
        check(max(grel.values()) <= MOE_GRAD_TOL, f"phase 14 (a) {label}: "
              f"gradients {grel} against the oracle beyond {MOE_GRAD_TOL}")
        check(torch.isfinite(y).all().item(), f"phase 14 (a) {label}: y")
        del y, grads, y_ref, g_ref
        ms = _wall_ms(lambda: _moe_layer_run(variant, inp), "cuda",
                      MOE_TIMED_RUNS)
        print(f"phase 14 (a) {label} capacity factor {variant[3]} at "
              f"{MOE_RANKS} virtual ranks, T_local {t}, D {d}, d_ff {f}: "
              f"{ms:.2f} ms per call (forward and backward, every rank) "
              f"on {smi}; routed choices dropped at capacity "
              f"{dropped_choices:.4f}, tokens that reached no expert "
              f"{dropped:.4f}; peak "
              f"{peak} bytes; against the oracle worst row {row:.4f} of "
              f"the limit, gradients {json.dumps(grel)}; at d"
              f"{MOE_SMALL['d']} the card against CPU threads: row "
              f"{ratio:.4f}, gradients {json.dumps(rel)}", flush=True)
        del inp
        torch.cuda.empty_cache()


class _LMRun:
    """Phase 7's model, optimizer and batch, with a step built under the
    in-step guard ``policy``, and the state that a guard and a checkpoint
    take."""

    def __init__(self, policy: str = "rollback", seed: int = 0):
        import os

        from horovod_tpu_torch.benchmark import (make_lm_bench_state,
                                                 make_lm_train_step)
        from horovod_tpu_torch.models.convert import lm_ordered_parameters

        torch.cuda.empty_cache()
        self.st = make_lm_bench_state(**LM, momentum_dtype="bfloat16",
                                      seed=seed)
        self.named = lm_ordered_parameters(self.st.model)
        self.params = [p for _, p in self.named]
        old = os.environ.get("HOROVOD_STEP_GUARD")
        os.environ["HOROVOD_STEP_GUARD"] = policy
        try:
            self.step = make_lm_train_step(
                self.st.model, self.st.optimizer, self.st.mesh, self.st.axis,
                attention="flash", remat="none")
        finally:
            if old is None:
                os.environ.pop("HOROVOD_STEP_GUARD")
            else:
                os.environ["HOROVOD_STEP_GUARD"] = old

    @property
    def trace(self):
        return self.st.optimizer.trace

    def state(self, step: int) -> dict:
        return {"params": dict(self.named), "trace": self.trace,
                "step": step}

    def run(self) -> float:
        return float(self.step(self.st.tokens, self.st.labels))


def _equal_snapshot(guard, run) -> list:
    """For each parameter, then each trace buffer: equal to the guard's
    committed host snapshot, bit for bit."""
    views = guard.lkg._committed[2].views
    leaves = run.params + list(run.trace)
    return [torch.equal(p, v.to(p.device)) for p, v in zip(leaves, views)]


def _phase_guard_and_checkpoint(smi: str, lm7: dict) -> list:
    """Phase 14 (b) and (c); returns the flash launches of their runs."""
    import os
    import shutil
    import tempfile

    from horovod_tpu_torch import checkpoint
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.optim import SGDState
    from horovod_tpu_torch.resilience import GuardEvent, StepGuard

    counters = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    for c in counters:
        c.reset()
    tmp = tempfile.mkdtemp(prefix="hvd_phase14_")
    try:
        # The clean run, guarded, with the two saves.
        run = _LMRun()
        guard = StepGuard(policy="rollback", snapshot_interval=1)
        clean, ms, stage, async_ms = [], [], [], []
        save_s = async_s = None
        for t in range(GUARD_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = run.run()
            _, _, ev = guard.after_step(run.params, run.trace, t, loss)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            check(ev == GuardEvent("ok", t), f"phase 14 (b) clean step {t}: "
                  f"{ev}")
            clean.append(loss)
            stage.append(guard.lkg.last_stage_seconds * 1e3)
            if ASYNC_STEP < t <= ASYNC_STEP + 2:
                async_ms.append(dt)
            elif t not in (ASYNC_STEP, CKPT_STEP):
                ms.append(dt)
            if t == ASYNC_STEP:
                t1 = time.perf_counter()
                checkpoint.save_async(os.path.join(tmp, "async"),
                                      run.state(t + 1), step=t + 1)
                async_s = time.perf_counter() - t1
            if t == ASYNC_STEP + 2:
                check(checkpoint.wait_for_async_save() is not None,
                      "phase 14 (c) the async save failed")
                async_write = checkpoint.last_async_write_seconds
                shutil.rmtree(os.path.join(tmp, "async"))
            if t == CKPT_STEP:
                t1 = time.perf_counter()
                path = checkpoint.save(os.path.join(tmp, "ckpt"),
                                       run.state(t + 1), step=t + 1)
                save_s = time.perf_counter() - t1
                check(path is not None, "phase 14 (c) the save failed")
                nbytes = os.path.getsize(os.path.join(
                    path, checkpoint.STATE_FILE))
        for loss in clean:
            check(loss == loss and abs(loss) != float("inf"),
                  f"phase 14 (b) clean losses {clean}")
        timed = lm7.get("step_losses", [])[:GUARD_STEPS - LM_WARMUP_STEPS]
        check(clean[LM_WARMUP_STEPS:LM_WARMUP_STEPS + len(timed)] == timed,
              f"phase 14 (b) the guarded clean losses {clean} are not "
              f"phase 7's {timed} bit for bit")
        del run, guard
        # The faulted run: a NaN gradient at GUARD_NAN_STEP.  Its step
        # has no in-step guard, so the NaN update lands and the loss stays
        # finite: only the StepGuard's stage can find the state bad, and
        # only its restore can bring it back.
        run = _LMRun(policy="off")
        guard = StepGuard(policy="rollback", snapshot_interval=1)
        poison = [False]
        hook = run.params[0].register_hook(
            lambda g: torch.full_like(g, float("nan")) if poison[0] else g)
        faulted, events = [], []
        for t in range(GUARD_STEPS):
            poison[0] = t == GUARD_NAN_STEP
            loss = run.run()
            if t == GUARD_NAN_STEP:
                bad = not torch.isfinite(run.params[0]).all().item()
                differ = [not e for e in _equal_snapshot(guard, run)]
                check(bad and differ[0] and differ[len(run.params)],
                      f"phase 14 (b) the NaN update did not land: the "
                      f"embedding finite {not bad}, differs from the "
                      f"snapshot {differ[0]}, its trace "
                      f"{differ[len(run.params)]}")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, _, ev = guard.after_step(run.params, run.trace, t, loss)
            torch.cuda.synchronize()
            guard_ms = (time.perf_counter() - t1) * 1e3
            faulted.append(loss)
            events.append(ev)
            if t == GUARD_NAN_STEP:
                rollback_ms = guard_ms
                check(ev == GuardEvent("rollback", GUARD_NAN_STEP - 1),
                      f"phase 14 (b) step {t}: {ev}, not a rollback to "
                      f"step {GUARD_NAN_STEP - 1}")
                check(all(_equal_snapshot(guard, run)),
                      "phase 14 (b) the rolled-back parameters and "
                      "trace are not the step-4 snapshot bit for bit")
        hook.remove()
        # The poisoned step's loss is the clean one (its forward ran before
        # the update); after the rollback the run repeats clean's from the
        # step after the snapshot.
        check(faulted[:GUARD_NAN_STEP + 1] == clean[:GUARD_NAN_STEP + 1]
              and faulted[GUARD_NAN_STEP + 1:]
              == clean[GUARD_NAN_STEP:GUARD_STEPS - 1],
              f"phase 14 (b) after the rollback the losses {faulted} are "
              f"not the clean run's from step {GUARD_NAN_STEP - 1} on, "
              f"{clean}, bit for bit")
        del run, guard
        # A fresh model restored from the save, for the steps after it.
        run = _LMRun()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        back = checkpoint.restore(os.path.join(tmp, "ckpt"),
                                  run.state(0))
        with torch.no_grad():
            for name, p in run.named:
                p.copy_(back["params"][name])
        run.st.optimizer.state = SGDState(list(back["trace"]))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        check(back["step"] == CKPT_STEP + 1, f"phase 14 (c) restored step "
              f"{back['step']}")
        resumed = [run.run() for _ in range(3)]
        check(resumed == clean[CKPT_STEP + 1:CKPT_STEP + 4],
              f"phase 14 (c) the restored run's losses {resumed} are not "
              f"the uninterrupted run's {clean[CKPT_STEP + 1:]} bit for bit")
        del run, back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    launched = [c.count for c in counters]
    print(f"phase 14 (b) LM d{LM['d_model']}/L{LM['n_layers']} under "
          f"StepGuard(rollback, snapshot_interval=1) on {smi}: "
          f"{statistics.median(ms):.2f} ms/step with the guard (phase 7: "
          f"{lm7.get('ms_per_step', float('nan')):.2f}), a stage "
          f"{statistics.median(stage):.2f} ms (median of {len(stage)}); "
          f"NaN gradient (embedding hook) at step {GUARD_NAN_STEP}, "
          f"applied by a step with no in-step guard (the embedding went "
          f"non-finite) -> {events[GUARD_NAN_STEP]} in {rollback_ms:.2f} "
          f"ms (the verdict and the host snapshot written into the live "
          f"tensors); parameters and trace equal the "
          f"step-{GUARD_NAN_STEP - 1} snapshot bit for bit; losses after "
          f"it equal the clean run's from step {GUARD_NAN_STEP - 1}: "
          f"{faulted}", flush=True)
    print(f"phase 14 (c) checkpoint of the LM of record's state on {smi}: "
          f"{nbytes} bytes written; save {save_s:.3f} s, save_async "
          f"{async_s:.3f} s blocking (write {async_write:.3f} s on its "
          f"thread), restore {restore_s:.3f} s; ms/step while the async "
          f"write ran {[round(v, 2) for v in async_ms]}; three restored "
          f"steps' losses {resumed} equal the uninterrupted run's bit for "
          f"bit; flash launches {launched}", flush=True)
    return launched


def _preempt_worker(ckpt_dir: str, mode: str) -> None:
    """Phase 14 (d)'s training program: the small bf16 LM of phase 11
    (c) for PREEMPT_STEPS steps; ``preempt`` asks for a preemption at
    PREEMPT_AT (a save, then exit 75), ``resume`` restores first; prints
    the final loss's bits."""
    import numpy as np

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint, resilience
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.optim import SGD, SGDState

    hvd.init()
    cfg = tfm.TransformerConfig(**SP_STEP_LM, dtype=torch.bfloat16)
    model = tfm.TransformerLM(cfg, device="cuda")
    model.load_state_dict(convert.lm_params_to_torch(_small_lm_tree(cfg,
                                                                    21)))
    named = convert.lm_ordered_parameters(model)
    opt = SGD([p for _, p in named], 0.1, momentum=0.9,
              accumulator_dtype=torch.bfloat16)
    step = tfm.make_train_step(model, opt, hvd.mesh(), attention="flash")
    toks = np.random.default_rng(22).integers(
        0, cfg.vocab_size, (SP_STEP_BATCH, cfg.max_seq + 1))
    tokens = torch.from_numpy(toks[:, :-1].copy()).cuda()
    labels = torch.from_numpy(toks[:, 1:].copy()).cuda()
    start = 0
    if mode == "resume":
        back = checkpoint.restore(ckpt_dir, {"params": dict(named),
                                             "trace": opt.trace, "step": 0})
        with torch.no_grad():
            for name, p in named:
                p.copy_(back["params"][name])
        opt.state = SGDState(list(back["trace"]))
        start = back["step"]
    loss = None
    for t in range(start, PREEMPT_STEPS):
        loss = float(step(tokens, labels))
        if mode == "preempt" and t + 1 == PREEMPT_AT:
            resilience.request_preemption()
        resilience.maybe_save_and_exit(
            ckpt_dir, {"params": dict(named), "trace": opt.trace,
                       "step": t + 1}, t + 1)
    print(f"final loss {loss.hex()} after step {PREEMPT_STEPS}", flush=True)
    hvd.shutdown()


def _phase_preemption(smi: str) -> None:
    """Phase 14 (d): preempted in one subprocess, resumed in another, the
    final loss held to an uninterrupted run's (a third) bit for bit."""
    import os
    import tempfile

    from horovod_tpu_torch import checkpoint

    script = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory(prefix="hvd_preempt_") as tmp:
        def run(mode):
            return subprocess.run(
                [sys.executable, script, "--preempt-worker", tmp, mode],
                capture_output=True, text=True, timeout=300)

        first = run("preempt")
        check(first.returncode == 75, f"phase 14 (d) the preempted run "
              f"exited {first.returncode}, not 75: {first.stderr[-2000:]}")
        saved = checkpoint.latest_step(tmp)
        check(saved == PREEMPT_AT, f"phase 14 (d) left step {saved}")
        second = run("resume")
        whole = run("whole")
        for res in (second, whole):
            check(res.returncode == 0, f"phase 14 (d) rc {res.returncode}: "
                  f"{res.stderr[-2000:]}")
        final = [ln for ln in second.stdout.splitlines()
                 if ln.startswith("final")]
        want = [ln for ln in whole.stdout.splitlines()
                if ln.startswith("final")]
        check(final and final == want, f"phase 14 (d) resumed {final}, "
              f"uninterrupted {want}")
    print(f"phase 14 (d) preemption on {smi}: rc 75 at step {PREEMPT_AT} "
          f"with checkpoint step {saved}; the resumed run's {final[0]} "
          f"equals the uninterrupted run's bit for bit", flush=True)


def phase_moe_and_resilience(smi: str, lm7: dict) -> list:
    """Phase 14 (a)-(d); returns the flash launches of (b) and (c)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _phase_moe(smi)
    launched = _phase_guard_and_checkpoint(smi, lm7)
    _phase_preemption(smi)
    return launched


def _warm_worker(tmp: str, attempt: str) -> None:
    """Phase 15 (a)'s training program, one launcher attempt: the LM of
    record under StepGuard(rollback) with the spill directory and the
    attempt from the environment, warm-restored first.  Attempt 0 saves
    the disk checkpoint and dies by SIGKILL right after committing
    WARM_KILL_STEP; attempt 1 starts from WARM_SEED and trains to
    WARM_STEPS.  Prints one ``WARM {json}`` line before it ends (or
    dies)."""
    import os
    import signal

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint, resilience
    from horovod_tpu_torch.ops import flash_attention as fa

    hvd.init()
    run = _LMRun(seed=0 if attempt == "0" else WARM_SEED)
    guard = resilience.StepGuard(policy="rollback", snapshot_interval=1)
    counters = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    for c in counters:
        c.reset()
    ckpt = os.path.join(tmp, "ckpt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, committed, source, extra = resilience.warm_restore(
        run.params, run.trace, ckpt_dir=ckpt)
    torch.cuda.synchronize()
    out = {"attempt": attempt, "source": source, "committed": committed,
           "extra": extra, "restore_s": time.perf_counter() - t0,
           "restore": dict(resilience.last_restore), "losses": {},
           "step_ms": {}, "spills": {}}
    for t in range(committed + 1, WARM_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = run.run()
        guard.spill_extra["cursor"] = t
        resilience.last_spill.clear()
        _, _, ev = guard.after_step(run.params, run.trace, t, loss)
        torch.cuda.synchronize()
        out["step_ms"][t] = (time.perf_counter() - t1) * 1e3
        out["losses"][t] = loss
        check(ev.action == "ok", f"phase 15 (a) attempt {attempt} step "
              f"{t}: {ev}")
        if resilience.last_spill:
            out["spills"][t] = dict(resilience.last_spill)
        if attempt == "0" and t == WARM_DISK_STEP:
            t1 = time.perf_counter()
            check(checkpoint.save(ckpt, {"params": run.params,
                                         "opt_state": run.trace,
                                         "step": t}, step=t) is not None,
                  "phase 15 (a) the disk checkpoint failed")
            out["save_s"] = time.perf_counter() - t1
        if attempt == "0" and t == WARM_KILL_STEP:
            break
    out["launches"] = [c.count for c in counters]
    print("WARM " + json.dumps(out), flush=True)
    if attempt == "0":
        # Dies as a lost host would: no unwind, no shutdown.
        os.kill(os.getpid(), signal.SIGKILL)
    hvd.shutdown()


def _disk_rung_worker(tmp: str, mode: str) -> None:
    """Phase 15 (b)'s training program: phase 14 (d)'s small LM under
    StepGuard(rollback), warm-restored first.  ``attempt0`` saves a disk
    checkpoint at DISK_RUNG_SAVE and stops after DISK_RUNG_KILL (its
    spills torn by the fault spec); ``attempt1`` trains to
    DISK_RUNG_STEPS; ``whole`` runs every step with no spill directory.
    Prints the source, the recovered step, the flash launches and the
    final loss's bits."""
    import os

    import numpy as np

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint, resilience
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.optim import SGD

    hvd.init()
    cfg = tfm.TransformerConfig(**SP_STEP_LM, dtype=torch.bfloat16)
    model = tfm.TransformerLM(cfg, device="cuda")
    model.load_state_dict(convert.lm_params_to_torch(_small_lm_tree(cfg,
                                                                    21)))
    named = convert.lm_ordered_parameters(model)
    params = [p for _, p in named]
    opt = SGD(params, 0.1, momentum=0.9, accumulator_dtype=torch.bfloat16)
    step = tfm.make_train_step(model, opt, hvd.mesh(), attention="flash")
    toks = np.random.default_rng(22).integers(
        0, cfg.vocab_size, (SP_STEP_BATCH, cfg.max_seq + 1))
    tokens = torch.from_numpy(toks[:, :-1].copy()).cuda()
    labels = torch.from_numpy(toks[:, 1:].copy()).cuda()
    counters = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    for c in counters:
        c.reset()
    guard = resilience.StepGuard(policy="rollback", snapshot_interval=1)
    ckpt = os.path.join(tmp, "ckpt")
    _, _, committed, source, _ = resilience.warm_restore(
        params, opt.trace, ckpt_dir=ckpt)
    last = DISK_RUNG_KILL if mode == "attempt0" else DISK_RUNG_STEPS - 1
    loss = None
    for t in range(committed + 1, last + 1):
        loss = float(step(tokens, labels))
        guard.after_step(params, opt.trace, t, loss)
        if mode == "attempt0" and t == DISK_RUNG_SAVE:
            checkpoint.save(ckpt, {"params": params, "opt_state": opt.trace,
                                   "step": t}, step=t)
    print(f"source {source} committed {committed} launches "
          f"{[c.count for c in counters]} final loss {loss.hex()} after "
          f"step {last}", flush=True)
    hvd.shutdown()


def _spill_header_step(path: str):
    """The step in a spill file's header, or None without a spill there."""
    from horovod_tpu_torch import resilience

    try:
        with open(path, "rb") as f:
            magic, _, step, *_ = resilience._SPILL_HEADER.unpack(
                f.read(resilience._SPILL_HEADER.size))
    except (OSError, ValueError):
        return None
    return step if magic == resilience.SPILL_MAGIC else None


def _phase_warm_restart(smi: str, lm7: dict) -> list:
    """Phase 15 (a): the LM of record killed after an unspilled commit
    and warm-restarted from its spill; returns the flash launches."""
    import os
    import shutil
    import tempfile

    script = os.path.abspath(__file__)
    tmp = tempfile.mkdtemp(prefix="hvd_phase15_")
    spill = os.path.join(tmp, "spill")
    try:
        def attempt(n: str):
            env = dict(os.environ, HOROVOD_SPILL_DIR=spill,
                       HOROVOD_RESTART_ATTEMPT=n,
                       HOROVOD_SPILL_INTERVAL=str(WARM_SPILL_INTERVAL))
            res = subprocess.run([sys.executable, script, "--warm-worker",
                                  tmp, n], capture_output=True, text=True,
                                 timeout=400, env=env)
            lines = [ln for ln in res.stdout.splitlines()
                     if ln.startswith("WARM ")]
            check(lines, f"phase 15 (a) attempt {n} rc {res.returncode} "
                  f"printed no result: {res.stderr[-3000:]}")
            return res, json.loads(lines[-1][5:])

        first, a0 = attempt("0")
        check(first.returncode == -9, f"phase 15 (a) attempt 0 exited "
              f"{first.returncode}, not by its SIGKILL")
        spills = sorted(int(t) for t in a0["spills"])
        newest = max(spills)
        check(a0["source"] == "fresh" and spills == [
            t for t in range(WARM_KILL_STEP + 1)
            if (t + 1) % WARM_SPILL_INTERVAL == 0],
              f"phase 15 (a) attempt 0: source {a0['source']}, spills at "
              f"{spills}")
        on_disk = _spill_header_step(os.path.join(spill, "rank0.spill"))
        check(on_disk == newest and WARM_DISK_STEP < newest
              < WARM_KILL_STEP, f"phase 15 (a) the spill on disk holds "
              f"step {on_disk}; expected {newest}, between the disk "
              f"checkpoint's {WARM_DISK_STEP} and the last commit "
              f"{WARM_KILL_STEP}")
        nbytes = os.path.getsize(os.path.join(spill, "rank0.spill"))
        second, a1 = attempt("1")
        check(second.returncode == 0, f"phase 15 (a) attempt 1 rc "
              f"{second.returncode}: {second.stderr[-3000:]}")
        check(a1["source"] == "spill" and a1["committed"] == newest
              and a1["extra"] == {"cursor": newest},
              f"phase 15 (a) attempt 1 recovered {a1['source']} step "
              f"{a1['committed']} extra {a1['extra']}; expected the spill "
              f"at step {newest} with cursor {newest}")
        timed = lm7.get("step_losses", [])
        held = {"0": [], "1": []}
        for run in (a0, a1):
            for t, loss in run["losses"].items():
                i = int(t) - LM_WARMUP_STEPS
                if 0 <= i < len(timed):
                    held[run["attempt"]].append(int(t))
                    check(loss == timed[i], f"phase 15 (a) attempt "
                          f"{run['attempt']} step {t} loss {loss!r} is not "
                          f"phase 7's {timed[i]!r}")
        check(len(a1["losses"]) == WARM_STEPS - newest - 1 and all(
            0 <= int(t) - LM_WARMUP_STEPS < len(timed) for t in a1["losses"]),
              f"phase 15 (a) attempt 1 ran steps {list(a1['losses'])}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    parts = {k: round(statistics.median(s[k] for s in a0["spills"].values()),
                      4) for k in next(iter(a0["spills"].values()))}
    plain = [a0["step_ms"][str(t)] for t in range(1, WARM_KILL_STEP + 1)
             if str(t) not in a0["spills"]]
    spilled = [a0["step_ms"][t] for t in a0["spills"]]
    print(f"phase 15 (a) LM d{LM['d_model']}/L{LM['n_layers']} killed after "
          f"committing step {WARM_KILL_STEP} (spills every "
          f"{WARM_SPILL_INTERVAL} commits, at steps {spills}; disk "
          f"checkpoint at step {WARM_DISK_STEP}) and warm-restarted from "
          f"another seed on {smi}: source {a1['source']} at step "
          f"{a1['committed']}, cursor {a1['extra']['cursor']}; losses of "
          f"steps {sorted(held['0'])} (attempt 0) and {sorted(held['1'])} "
          f"(attempt 1) equal phase 7's bit for bit (phase 7 keeps no loss "
          f"of its {LM_WARMUP_STEPS} warm-up steps, so attempt 0's steps "
          f"below {LM_WARMUP_STEPS} are not held)", flush=True)
    print(f"phase 15 (a) a spill: {nbytes} bytes; seconds (median of "
          f"{len(spilled)}) {json.dumps(parts)}; ms/step with a spill "
          f"{[round(v, 2) for v in spilled]}, without "
          f"{[round(v, 2) for v in plain]}; disk save {a0['save_s']:.3f} s; "
          f"warm_restore {a1['restore_s']:.3f} s "
          f"{json.dumps({k: v for k, v in a1['restore'].items() if k.endswith('_s')})}; "
          f"flash launches attempt 0 {a0['launches']}, attempt 1 "
          f"{a1['launches']}", flush=True)
    return [x + y for x, y in zip(a0["launches"], a1["launches"])]


def _phase_disk_rung(smi: str) -> list:
    """Phase 15 (b): the ladder's disk rung and the attempt key; returns
    the flash launches."""
    import os
    import re
    import tempfile

    from horovod_tpu_torch import resilience

    script = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory(prefix="hvd_disk_rung_") as tmp:
        def run(mode: str, attempt: str):
            env = dict(os.environ, HOROVOD_RESTART_ATTEMPT=attempt,
                       HOROVOD_FAULT_SPEC=DISK_RUNG_FAULT,
                       HOROVOD_SPILL_INTERVAL="1")
            if mode != "whole":
                env["HOROVOD_SPILL_DIR"] = os.path.join(tmp, "spill")
            res = subprocess.run([sys.executable, script, "--disk-worker",
                                  tmp if mode != "whole" else
                                  os.path.join(tmp, "whole"), mode],
                                 capture_output=True, text=True, timeout=300,
                                 env=env)
            check(res.returncode == 0, f"phase 15 (b) {mode} rc "
                  f"{res.returncode}: {res.stderr[-3000:]}")
            return res

        first = run("attempt0", "0")
        torn = first.stderr.count("firing kind=spill_corrupt")
        second = run("attempt1", "1")
        whole = run("whole", "0")
        rec = resilience.read_spill(os.path.join(tmp, "spill",
                                                 "rank0.spill"))
        spilled = None if rec is None else rec["step"]
    check(torn == DISK_RUNG_KILL + 1, f"phase 15 (b) attempt 0 tore {torn} "
          f"spills; expected one a commit, {DISK_RUNG_KILL + 1}")
    check("firing" not in second.stderr, "phase 15 (b) a fault fired in "
          "attempt 1: " + second.stderr[-2000:])
    check(f"source disk committed {DISK_RUNG_SAVE} " in second.stdout,
          f"phase 15 (b) attempt 1: {second.stdout[-500:]}")
    check(spilled == DISK_RUNG_STEPS - 1, f"phase 15 (b) attempt 1's spill "
          f"holds step {spilled}, not a whole one of step "
          f"{DISK_RUNG_STEPS - 1}")
    final = re.findall(r"final loss (\S+)", second.stdout)
    want = re.findall(r"final loss (\S+)", whole.stdout)
    check(final and final == want, f"phase 15 (b) final loss {final}, "
          f"uninterrupted {want}")
    launches = [0, 0, 0]
    for res in (first, second):
        got = re.findall(r"launches \[(\d+), (\d+), (\d+)\]", res.stdout)
        launches = [a + int(b) for a, b in zip(launches, got[0])]
    print(f"phase 15 (b) small LM on {smi}: attempt 0's {torn} spills torn "
          f"by {DISK_RUNG_FAULT!r}; attempt 1 rejected the spill, restored "
          f"the disk checkpoint of step {DISK_RUNG_SAVE}, fired no fault "
          f"and left a whole spill of step {spilled}; its final loss "
          f"{final[0]} equals the uninterrupted run's bit for bit", flush=True)
    return launches


def phase_warm_restart(smi: str, lm7: dict) -> list:
    """Phase 15 (a) and (b); returns their flash launches."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    warm = _phase_warm_restart(smi, lm7)
    disk = _phase_disk_rung(smi)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s", flush=True)
    return [a + b for a, b in zip(warm, disk)]


def _moe_process_worker(rank, size, addr, backend, out_dir):
    """Phase 14 (e)'s program on one rank of ``size``: the ragged
    all-to-all (payloads naming sender, destination and row; a capacity
    that drops rows; the gradient), an f32 ``moe_layer_ragged`` forward
    and backward at overflow, and a reducescatter whose shape is bad on
    one rank."""
    import os

    import numpy as np

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import collective as C
    from horovod_tpu_torch.parallel import expert as ep

    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=addr)
    hvd.init(device=None if backend == "nccl" else "cpu")
    try:
        dev = hvd.mesh().device
        out = {}
        splits, rows = _ragged_payload(size)
        x = torch.from_numpy(rows[rank]).to(dev).requires_grad_()
        o, recv = C.alltoall_ragged(x, torch.from_numpy(splits[rank]),
                                    MOE_A2A_CAP, None)
        gx, = torch.autograd.grad((o ** 2).sum(), x)
        out["a2a"] = [o.detach().cpu(), recv.cpu(), gx.cpu()]
        inp = _moe_inputs(32, 64, 64, "cpu", 52, n=size)
        lv = {k: (inp[k][rank] if k != "router" else inp[k]).clone().to(
            dev).float().requires_grad_() for k in ("x", "router", "w1",
                                                   "w2")}
        y = ep.moe_layer_ragged(
            lv["x"], lv["router"],
            lambda p, tok: torch.tanh(tok @ p["w1"]) @ p["w2"],
            {"w1": lv["w1"], "w2": lv["w2"]}, None, 0.75)
        grads = torch.autograd.grad(
            (y * inp["ct"][rank].to(dev)).sum(), list(lv.values()))
        out["moe"] = [y.detach().cpu()] + [g.cpu() for g in grads]
        t0 = time.perf_counter()
        try:
            hvd.reducescatter(torch.ones(2 * size + (rank > 0), device=dev),
                              name="phase14.bad.rs")
            out["bad"] = "no error"
        except RuntimeError as e:
            out["bad"] = str(e)
        out["bad_seconds"] = time.perf_counter() - t0
        torch.save(out, f"{out_dir}/moe_{backend}{rank}.pt")
    finally:
        hvd.shutdown()


def _ragged_payload(size: int):
    """Per rank: splits [size] and rows [MOE_A2A_ROWS, 3], row i of the
    block for d carrying (sender, d, i); rows past sum(splits) junk."""
    import numpy as np

    g = np.random.default_rng(51)
    splits = g.integers(0, 4, size=(size, size)).astype(np.int64)
    rows = np.full((size, MOE_A2A_ROWS, 3), -777.0, np.float32)
    for s in range(size):
        k = 0
        for d in range(size):
            for i in range(splits[s, d]):
                rows[s, k] = (s, d, i)
                k += 1
    return splits, rows


def run_moe_processes(backend: str, size: int, out_dir: str) -> list:
    """Phase 14 (e)'s program on ``size`` ranks over ``backend`` (NCCL:
    one card a rank; gloo: the CPU)."""
    _spawn(_moe_process_worker, size, (backend,), out_dir)
    return [torch.load(f"{out_dir}/moe_{backend}{r}.pt", weights_only=False)
            for r in range(size)]


def compare_moe_processes(nccl: list, gloo: list) -> dict:
    """NCCL's answers against gloo's: the ragged exchange and its gradient
    bit for bit, the f32 MoE layer and its gradients within MOE_F32_TOL
    (||a - b|| / ||b||), the bad reducescatter failing every rank with the
    coordinator's words within 10 s."""
    size = len(nccl)
    words = (f"Mismatched reducescatter tensor shapes for tensor "
             f"phase14.bad.rs.")
    worst = 0.0
    for r, (a, b) in enumerate(zip(nccl, gloo)):
        for x, y in zip(a["a2a"], b["a2a"]):
            check(torch.equal(x, y), f"phase 14 (e) rank {r}: the ragged "
                  f"all-to-all over NCCL differs from gloo's")
        for x, y in zip(a["moe"], b["moe"]):
            rel = ((x - y).norm() / y.norm().clamp_min(1e-30)).item()
            worst = max(worst, rel)
        for res in (a, b):
            check(res["bad"] == words and res["bad_seconds"] < 10,
                  f"phase 14 (e) rank {r}: the bad reducescatter gave "
                  f"{res['bad']!r} after {res['bad_seconds']:.1f} s")
    check(worst <= MOE_F32_TOL, f"phase 14 (e) moe_layer_ragged over NCCL "
          f"{worst:.3g} from gloo's")
    return {"ranks": size, "moe_worst_rel": worst,
            "bad_seconds": max(r["bad_seconds"] for r in nccl)}


def phase_moe_processes(smi: str) -> None:
    """Phase 14 (e): across NCCL processes, where the host has the cards
    for it."""
    import tempfile

    n = torch.cuda.device_count()
    if n < 2:
        print(f"phase 14 (e) did not run: {n} CUDA device here, and the "
              f"ragged exchange and the coordinator's shape check across "
              f"NCCL processes need one card a rank (NCCL refuses two ranks "
              f"on one card)", flush=True)
        return
    size = min(n, 4)
    with tempfile.TemporaryDirectory() as out:
        nccl = run_moe_processes("nccl", size, out)
        gloo = run_moe_processes("gloo", size, out)
    print(f"phase 14 (e): alltoall_ragged (capacity {MOE_A2A_CAP}, with "
          f"drops), moe_layer_ragged (f32, overflow) and a bad "
          f"reducescatter over NCCL on {size} cards ({smi}) against gloo "
          f"on the CPU: " + json.dumps(compare_moe_processes(nccl, gloo)),
          flush=True)


# ---------------------------------------------------------------------------
# The control plane's own instruments
# ---------------------------------------------------------------------------

def _run_control_worker(mode: str, out_dir: str, extra=()) -> dict:
    """Run this script's ``--control-worker`` in a process of its own, so
    that the environment knobs it sets are read at ``init``; returns the
    JSON it wrote."""
    import os

    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--control-worker", mode, out_dir, *extra],
                         capture_output=True, text=True, timeout=300)
    sys.stdout.write(res.stdout)
    check(res.returncode == 0, f"phase 16 {mode} worker failed "
          f"(rc {res.returncode}): {res.stderr[-3000:]}")
    with open(os.path.join(out_dir, f"{mode}_result.json")) as f:
        return json.load(f)


def _control_worker(mode: str, out_dir: str, *args: str) -> None:
    """Phase 16's program: phase 10's ResNet-50 step from a fresh state
    for CONTROL_STEPS steps, under ``timeline`` (HOROVOD_TIMELINE with
    cycle markers; the timed window is phase 10's, steps 4-13, back to
    back) or ``autotune`` (HOROVOD_AUTOTUNE with samples sized from the
    busy cycles a step that ``timeline`` counted and the warm-up ended
    after step 13, each step timed on its own, and on past CONTROL_STEPS
    until three pinned steps; then ``sync_tuned_config`` and one step
    whose gradients take
    the bucketed mean, ``fusion.fused_pytree_mean``).  Writes
    ``<mode>_result.json``."""
    import os

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.benchmark import make_bench_state
    from horovod_tpu_torch.ops import fused_stem, fusion

    if mode == "timeline":
        os.environ.update(
            HOROVOD_TIMELINE=os.path.join(out_dir, "timeline.json"),
            HOROVOD_TIMELINE_MARK_CYCLES="1")
    else:
        busy_per_step = float(args[0])
        per_sample = max(1, int(busy_per_step // 4))
        os.environ.update(
            HOROVOD_AUTOTUNE="1",
            HOROVOD_AUTOTUNE_LOG=os.path.join(out_dir, "autotune.csv"),
            # The default configuration through phase 10's 13 steps, then
            # the search: one sample is about a quarter of a step.  The
            # warm-up counts busy cycles, and their number a step is the
            # host's (37 and 135 in two runs on one H100), so the loop
            # below holds the search until step 13 itself.
            HOROVOD_AUTOTUNE_WARMUP_SAMPLES=str(10 ** 9),
            HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE=str(per_sample),
            HOROVOD_AUTOTUNE_SAMPLES="1",
            HOROVOD_AUTOTUNE_BAYES_TRIALS=str(CONTROL_TRIALS),
            HOROVOD_AUTOTUNE_DRIFT_WINDOWS=str(10 ** 6))
    hvd.init()
    rt = hvd.basics.runtime()
    st = make_bench_state("resnet50", batch_size=BATCH, image_size=IMAGE,
                          stem="s2d_fused", input_dtype="bfloat16")
    step, params, remove = _hooked_resnet_step(hvd, st)
    fused_stem.launches.reset()
    out = {"losses": [], "ms": [], "phase": []}
    busy0 = rt.busy_cycles
    window = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for i in range(CONTROL_STEPS_MAX):
        if i >= CONTROL_STEPS and (mode != "autotune"
                                   or out["phase"].count("pinned") >= 3):
            break
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        if i == WARMUP_STEPS:
            window[0].record()
        pinned = rt.tuner is not None and rt.tuner.monitoring
        t0.record()
        out["losses"].append(step())
        t1.record()
        if i == WARMUP_STEPS + TIMED_STEPS - 1:
            window[1].record()
        if mode == "autotune":
            torch.cuda.synchronize()
            out["ms"].append(t0.elapsed_time(t1))
            tuner = rt.tuner
            out["phase"].append("pinned" if pinned else (
                "default" if tuner.trials == 0 and tuner.active
                else "search"))
            if i == WARMUP_STEPS + TIMED_STEPS - 1:
                # The end of the warm-up; the lock is the one the cycle
                # thread takes to score a sample.
                with rt._tuner_lock:
                    tuner.warmup_remaining = 0
    torch.cuda.synchronize()
    out["losses"] = [float(x) for x in out["losses"]]
    out["busy_cycles_per_step"] = ((rt.busy_cycles - busy0)
                                   / len(out["losses"]))
    out["window_ms_per_step"] = window[0].elapsed_time(window[1]) / TIMED_STEPS
    out["fused_stem_launches"] = fused_stem.launches.count
    out["config"] = rt.tuned_config()
    if mode == "autotune":
        check(rt.tuner.monitoring, f"phase 16 (b): the tuner did not pin in "
              f"{len(out['losses'])} steps (phases {out['phase']})")
        pinned = rt.tuner.fusion_threshold
        agreed = rt.sync_tuned_config()["fusion_threshold_bytes"]
        out["pinned"] = {"cycle_time_ms": rt.tuner.cycle_time_ms,
                         "fusion_threshold_bytes": pinned,
                         "cache_enabled": rt.tuner.cache_enabled}
        out["agreed"] = agreed
        out["live"] = fusion.fusion_threshold_bytes()
        # The next step, its gradients averaged by the bucketer, which
        # follows the agreed threshold.
        remove()
        loss = torch.nn.functional.cross_entropy(st.model(st.images),
                                                 st.labels)
        loss.backward()
        grads = [p.grad for p in params]
        calls0 = fusion.allreduce_calls.count
        fusion.fused_pytree_mean(grads)
        torch.cuda.synchronize()
        out["buckets"] = fusion.allreduce_calls.count - calls0
        out["plan_buckets"] = len(fusion._bucket_leaves(grads, agreed))
        out["default_buckets"] = len(fusion._bucket_leaves(
            grads, fusion.DEFAULT_FUSION_THRESHOLD))
        out["fused_stem_launches"] = fused_stem.launches.count
    hvd.shutdown()
    with open(os.path.join(out_dir, f"{mode}_result.json"), "w") as f:
        json.dump(out, f)


def _timeline_events(path: str) -> dict:
    """Per tensor row of a timeline: (name, start, end) of each B/E pair."""
    with open(path) as f:
        events = json.load(f)
    rows = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    spans: dict = {name: [] for name in rows.values()}
    open_: dict = {}
    for e in events:
        if e["ph"] not in "BE" or e["tid"] not in rows:
            continue
        stack = open_.setdefault(e["tid"], [])
        if e["ph"] == "B":
            stack.append(e)
        else:
            b = stack.pop()
            spans[rows[e["tid"]]].append((b["name"], b["ts"], e["ts"]))
    spans["__cycles__"] = sum(e["name"] == "CYCLE_START" for e in events)
    return spans


def phase_control_instruments(smi: str, main: dict, ctl: dict) -> int:
    """Phase 16 (a) and (b), each in a worker process, and (c) where the
    host has the cards for it; returns the fused-stem launches."""
    import csv
    import os
    import tempfile

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="hvd_control_") as tmp:
        tl = _run_control_worker("timeline", tmp)
        path = os.path.join(tmp, "timeline.json")
        size = os.path.getsize(path)
        spans = _timeline_events(path)
        at = _run_control_worker("autotune", tmp,
                                 [str(tl["busy_cycles_per_step"])])
        with open(os.path.join(tmp, "autotune.csv")) as f:
            rows = list(csv.DictReader(f))
    want = main["step_losses"]
    for tag, res in (("(a)", tl), ("(b)", at)):
        check(res["losses"][WARMUP_STEPS:WARMUP_STEPS + TIMED_STEPS] == want,
              f"phase 16 {tag} losses differ from phase 4's: "
              f"{res['losses']} vs {want}")
    check(at["losses"][:len(tl["losses"])] == tl["losses"], f"phase 16 "
          f"(b)'s losses {at['losses']} differ from (a)'s {tl['losses']}")
    # (a): every gradient's events, the wire's time on the card above 0.
    names = [f"grad.{i}" for i in range(ctl["gradients"])]
    for name in names:
        got = spans.get(name, [])
        kinds = {k for k, _, _ in got}
        check({"NEGOTIATE_ALLREDUCE", "ALLREDUCE",
               "NCCL_ALLREDUCE"} <= kinds, f"phase 16 (a): {name}'s "
              f"timeline events {sorted(kinds)}")
        wire = [e - s for k, s, e in got if k == "NCCL_ALLREDUCE"]
        check(len(wire) == CONTROL_STEPS and min(wire) > 0,
              f"phase 16 (a): {name}'s NCCL_ALLREDUCE durations {wire}")
    check(spans["__cycles__"] > 0, "phase 16 (a): no CYCLE_START marker")
    wire_us = [e - s for n in names for k, s, e in spans[n]
               if k == "NCCL_ALLREDUCE"]
    # (b): the log explores, varies a parameter and pins last.
    check(len(rows) >= 5 and rows[-1]["pinned"] == "1"
          and (len({r["cycle_time_ms"] for r in rows}) > 1
               or len({r["fusion_threshold_mb"] for r in rows}) > 1),
          f"phase 16 (b): the trial log {rows}")
    pinned = at["pinned"]["fusion_threshold_bytes"]
    check(at["agreed"] == at["live"] == pinned
          and at["config"]["fusion_threshold_bytes"] == pinned,
          f"phase 16 (b): sync_tuned_config gave {at['agreed']}, the "
          f"bucketer {at['live']}, the tuner pinned {pinned}")
    check(at["buckets"] == at["plan_buckets"], f"phase 16 (b): "
          f"{at['buckets']} bucket all-reduces at the agreed threshold, "
          f"the plan has {at['plan_buckets']}")
    before = [m for m, p in zip(at["ms"], at["phase"])
              if p == "default"][WARMUP_STEPS:]
    after = [m for m, p in zip(at["ms"], at["phase"]) if p == "pinned"]
    check(len(before) >= 3 and len(after) >= 3, f"phase 16 (b): steps "
          f"before the search {len(before)}, after the pin {len(after)}")
    launches = tl["fused_stem_launches"] + at["fused_stem_launches"]
    passes = len(tl["losses"]) + len(at["losses"]) + 1
    check(launches == passes, f"fused_stem launched {launches} times in "
          f"phase 16's {passes} forward passes")
    result = {
        "timeline": {"ms_per_step": tl["window_ms_per_step"],
                     "phase10_ms_per_step": ctl["ms_per_step"],
                     "bytes": size, "bytes_per_step": size / CONTROL_STEPS,
                     "busy_cycles_per_step": tl["busy_cycles_per_step"],
                     "nccl_allreduce_us_median":
                         statistics.median(wire_us)},
        "autotune": {"trials": len(rows) - 1, "pinned": at["pinned"],
                     "ms_per_step_before": statistics.mean(before),
                     "ms_per_step_after": statistics.mean(after),
                     "steps_before": len(before), "steps_after": len(after),
                     "buckets_at_pinned": at["buckets"],
                     "buckets_at_64mb": at["default_buckets"]},
        "nvidia_smi": smi}
    print(f"phase 16 (a): ResNet-50 s2d_fused, batch {BATCH}, the timeline "
          f"on: {tl['window_ms_per_step']:.2f} ms/step (phase 10 without "
          f"it: {ctl['ms_per_step']:.2f}) on {smi}; {size} bytes in "
          f"{CONTROL_STEPS} steps; each of the {len(names)} gradients has "
          f"NEGOTIATE_ALLREDUCE, ALLREDUCE and NCCL_ALLREDUCE (> 0 us on the "
          f"card, median {result['timeline']['nccl_allreduce_us_median']} "
          f"us); every loss equals phase 4's bit for bit", flush=True)
    print(f"phase 16 (b): the tuner pinned {at['pinned']} after "
          f"{len(rows) - 1} trials; {statistics.mean(before):.2f} ms/step "
          f"before the search, {statistics.mean(after):.2f} after the pin; "
          f"sync_tuned_config agreed {at['agreed']} bytes and the next "
          f"step's bucketed mean took {at['buckets']} all-reduces (64 MB: "
          f"{at['default_buckets']}); every loss equals (a)'s bit for bit",
          flush=True)
    phase_deadline_processes(smi)
    print(f"phase 16: {time.perf_counter() - t_start:.1f} s; "
          + json.dumps(result), flush=True)
    return launches


def _deadline_worker(rank, size, addrs, out_dir):
    """Phase 16 (c)'s program on one NCCL rank of ``size``: under a 3 s
    deadline rank 1 never submits ``stalled``; then the job again as a
    rank subset of all but the last process, with the sets [0, 1] and
    [1, 2] (or [0, 1] alone at 2 ranks) and their collectives."""
    import os

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.native.runtime import EagerStallError

    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=addrs[0],
                      HOROVOD_EAGER_OP_TIMEOUT=str(DEADLINE_S))
    out = {}

    def stage(what):
        print(f"phase 16 (c) rank {rank}: {what}", flush=True)

    hvd.init()
    try:
        dev = hvd.basics.device()
        hvd.allreduce(torch.ones(1, device=dev), name="start")
        stage("started")
        if rank == 0:
            t0 = time.perf_counter()
            try:
                hvd.allreduce(torch.ones(4, device=dev), name="stalled")
                out["stall"] = "no error"
            except EagerStallError as e:
                out["stall"] = str(e)
            out["stall_seconds"] = time.perf_counter() - t0
            stage("the deadline passed")
    finally:
        hvd.shutdown()
    stage("shut down")
    os.environ.update(HOROVOD_COORDINATOR_ADDR=addrs[1])
    os.environ.pop("HOROVOD_EAGER_OP_TIMEOUT")
    members = list(range(size - 1)) if size > 2 else [0, 1]
    hvd.init(ranks=members)
    try:
        dev = hvd.basics.device()
        r, n = hvd.rank(), hvd.size()
        stage(f"a subset job of {members}")
        if rank in members:
            sets = [hvd.add_process_set([0, 1])]
            if n > 2:
                sets.append(hvd.add_process_set([1, 2]))
            stage(f"sets {[ps.ranks for ps in sets]} registered")
            for k, ps in enumerate(sets):
                if not ps.included():
                    continue
                x = torch.arange(6.0, device=dev) * (r + 1) + k
                out[f"set{k}"] = [
                    hvd.allreduce(x, op=hvd.Sum, name=f"s{k}.sum",
                                  process_set=ps).cpu(),
                    hvd.allgather(x[:ps.rank() + 1], name=f"s{k}.ag",
                                  process_set=ps).cpu(),
                    hvd.broadcast(x, ps.ranks[1], name=f"s{k}.bc",
                                  process_set=ps).cpu()]
                stage(f"set {ps.ranks} done")
        out["world"] = (r, n)
        torch.save(out, f"{out_dir}/deadline{rank}.pt")
    finally:
        hvd.shutdown()


def phase_deadline_processes(smi: str) -> None:
    """Phase 16 (c): across NCCL processes, where the host has the cards
    for it."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    n = torch.cuda.device_count()
    if n < 2:
        print(f"phase 16 (c) did not run: {n} CUDA device here, and the "
              f"eager-op deadline across NCCL processes and process sets "
              f"inside a rank-subset job need one card a rank (NCCL refuses "
              f"two ranks on one card)", flush=True)
        return
    size = min(n, 4)
    addrs = []
    for _ in range(2):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            addrs.append(f"127.0.0.1:{sock.getsockname()[1]}")
    with tempfile.TemporaryDirectory() as out:
        ctx = mp.start_processes(_deadline_worker, args=(size, addrs, out),
                                 nprocs=size, start_method="spawn",
                                 join=False)
        end = time.monotonic() + DEADLINE_JOB_S
        while not ctx.join(timeout=5):
            if time.monotonic() > end:
                for p in ctx.processes:
                    p.kill()
                check(False, f"phase 16 (c): the NCCL processes did not "
                      f"finish in {DEADLINE_JOB_S} s")
        res = [torch.load(f"{out}/deadline{r}.pt", weights_only=False)
               for r in range(size)]
    msg, secs = res[0]["stall"], res[0]["stall_seconds"]
    check(msg.startswith("Stalled eager op 'stalled': submitted by rank 0")
          and f"suspected missing ranks: {list(range(1, size))}" in msg
          and DEADLINE_S <= secs < DEADLINE_S + 2,
          f"phase 16 (c): after {secs:.2f} s rank 0 got {msg!r}")
    members = list(range(size - 1)) if size > 2 else [0, 1]
    sets = [[0, 1]] + ([[1, 2]] if len(members) > 2 else [])
    for k, ranks in enumerate(sets):
        for pos, r in enumerate(ranks):
            x = [torch.arange(6.0) * (m + 1) + k for m in ranks]
            want = [sum(x), torch.cat([v[:i + 1] for i, v in enumerate(x)]),
                    x[1]]
            got = res[r][f"set{k}"]
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"phase 16 (c) set {ranks} rank {r}: {got} != {want}")
    print(f"phase 16 (c): over NCCL on {size} cards ({smi}) rank 0's wait "
          f"on a name rank 1 never submitted raised EagerStallError after "
          f"{secs:.2f} s ({DEADLINE_S:g} s deadline) naming it and ranks "
          f"{list(range(1, size))}; in a rank-subset job of {members} the "
          f"sets {sets} gave exact allreduce, allgather and broadcast",
          flush=True)


# ---------------------------------------------------------------------------
# Phase 17: the telemetry layer and the schedule verifier on the card
# ---------------------------------------------------------------------------

TELEMETRY_MODES = ("off", "metrics", "schedule")
# Each mode's knobs ("timeline" stands for the eager timeline's path); the
# last three split "metrics" by consumer for phase_telemetry_attribution.
TELEMETRY_ENV = {
    "off": {},
    "metrics": {"HOROVOD_METRICS": "1", "HOROVOD_TRACE": "1",
                "HOROVOD_EAGER_TIMELINE": "timeline"},
    "schedule": {"HOROVOD_SCHEDULE_CHECK": "1"},
    "metrics_only": {"HOROVOD_METRICS": "1"},
    "trace_only": {"HOROVOD_TRACE": "1"},
    "timeline_only": {"HOROVOD_EAGER_TIMELINE": "timeline"},
}
TELEMETRY_KNOBS = ("HOROVOD_METRICS", "HOROVOD_TRACE", "HOROVOD_EAGER_TIMELINE",
                   "HOROVOD_SCHEDULE_CHECK")
TELEMETRY_ATTRIBUTION = ("off", "metrics", "metrics_only", "trace_only",
                         "timeline_only", "off", "metrics", "timeline_only",
                         "trace_only", "metrics_only")
TELEMETRY_LM_STEPS = (1, 2)     # (warm-up, timed): 3 steps


def _series_total(snap: dict, name: str, **labels) -> float:
    return sum(v["value"] for v in snap.get(name, {}).get("values", [])
               if all(v["labels"].get(k) == x for k, x in labels.items()))


def _telemetry_worker(out_dir: str, modes: str) -> None:
    """Phase 17 (a)'s program: phase 10's ResNet-50 step from a fresh
    state for phase 10's 13 steps, once per mode of the comma-separated
    ``modes`` (:data:`TELEMETRY_ENV`: telemetry unset; ``HOROVOD_METRICS``
    + ``HOROVOD_TRACE`` + ``HOROVOD_EAGER_TIMELINE``;
    ``HOROVOD_SCHEDULE_CHECK``; each consumer alone), each under an
    ``init`` of its own that reads the knobs.  Writes
    ``telemetry_result.json``: ``runs`` in order."""
    import os

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import telemetry
    from horovod_tpu_torch.benchmark import make_bench_state
    from horovod_tpu_torch.native import runtime as runtime_mod
    from horovod_tpu_torch.ops import fused_stem, fusion

    steps = WARMUP_STEPS + TIMED_STEPS
    tl_path = os.path.join(out_dir, "eager_timeline.json")
    runs = []
    fused_stem.launches.reset()
    for mode in modes.split(","):
        for knob in TELEMETRY_KNOBS:
            os.environ.pop(knob, None)
        os.environ.update({k: tl_path if v == "timeline" else v
                           for k, v in TELEMETRY_ENV[mode].items()})
        telemetry.reset_for_tests()
        hvd.init()
        rt = hvd.basics.runtime()
        st = make_bench_state("resnet50", batch_size=BATCH, image_size=IMAGE,
                              stem="s2d_fused", input_dtype="bfloat16")
        step, params, remove = _hooked_resnet_step(hvd, st)
        runtime_mod.requests.reset()
        fusion.allreduce_calls.reset()
        sp = telemetry.spans()
        window = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        losses = []
        for i in range(steps):
            if i == WARMUP_STEPS:
                window[0].record()
            losses.append(step())
        window[1].record()
        torch.cuda.synchronize()
        snap = telemetry.metrics_snapshot()
        res = {"mode": mode, "losses": [float(x) for x in losses],
               "ms_per_step": window[0].elapsed_time(window[1])
               / TIMED_STEPS,
               "steps": steps, "gradients": len(params),
               "grad_bytes": sum(p.numel() * p.element_size()
                                 for p in params),
               "requests": runtime_mod.requests.count,
               "allreduce_calls": fusion.allreduce_calls.count,
               "eager_ops": _series_total(snap, "hvd_eager_ops_total"),
               "fusion_buckets": _series_total(snap,
                                               "hvd_fusion_buckets_total"),
               "collective_bytes": _series_total(
                   snap, "hvd_collective_bytes_total"),
               "series": len(snap), "spans": len(sp) if sp else 0,
               "sched_submissions": rt.sched_submissions,
               "sched_divergences": rt.sched_divergences}
        remove()
        del st, step, params
        hvd.shutdown()
        for knob in TELEMETRY_KNOBS:
            os.environ.pop(knob, None)
        telemetry.reset_for_tests()     # closes the eager timeline
        res["timeline_bytes"] = (os.path.getsize(tl_path)
                                 if os.path.exists(tl_path) else 0)
        if os.path.exists(tl_path):
            os.remove(tl_path)
        runs.append(res)
    with open(os.path.join(out_dir, "telemetry_result.json"), "w") as f:
        json.dump({"runs": runs,
                   "fused_stem_launches": fused_stem.launches.count}, f)


def _run_telemetry_worker(modes) -> dict:
    """Run :func:`_telemetry_worker` over ``modes`` in a process of its
    own (the knobs are read at ``init`` and at import); its JSON."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory(prefix="hvd_telemetry_") as tmp:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--telemetry-worker", tmp, ",".join(modes)],
                             capture_output=True, text=True, timeout=600)
        sys.stdout.write(res.stdout)
        check(res.returncode == 0, f"phase 17 worker failed (rc "
              f"{res.returncode}): {res.stderr[-3000:]}")
        with open(os.path.join(tmp, "telemetry_result.json")) as f:
            return json.load(f)


def _phase_telemetry_lm(smi: str) -> list:
    """Phase 17 (b): the LM of record through the ZeRO-1 ``int8`` step
    for 3 steps with metrics on, in this process.  Returns the flash
    launches."""
    from horovod_tpu_torch import telemetry
    from horovod_tpu_torch.benchmark import run_lm_benchmark
    from horovod_tpu_torch.ops import flash_attention as fa

    plan, wire_int8, _ = _zero_plan("int8")
    _, wire_none, _ = _zero_plan("none")
    ratio13 = wire_int8 / wire_none     # phase 13's wire ratio, exactly
    flash = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    for c in flash:
        c.reset()
    warm, timed = TELEMETRY_LM_STEPS
    steps = warm + timed
    torch.cuda.empty_cache()
    telemetry.registry().clear()
    telemetry.configure(enabled_flag=True)
    try:
        res = run_lm_benchmark(
            **LM, attention="flash", remat="none", momentum_dtype="bfloat16",
            num_warmup_batches=warm, num_batches_per_iter=1,
            num_iters=timed, shard_optimizer=True, compression="int8",
            verbose=False)
        snap = telemetry.metrics_snapshot()
    finally:
        telemetry.configure(enabled_flag=False)
        telemetry.registry().clear()
    launched = [c.count for c in flash]
    n = LM["n_layers"] * steps
    check(launched == [n, n, n], f"phase 17 (b) flash launches {launched}; "
          f"expected {n} each ({steps} steps)")
    for i, loss in enumerate(res["step_losses"]):
        check(loss == loss and abs(loss) != float("inf"),
              f"phase 17 (b) step {i} loss is not finite: {loss}")
    nb = len(plan.buckets)
    updates = _series_total(snap, "hvd_zero_updates_total")
    buckets = _series_total(snap, "hvd_zero_buckets_total")
    shards = snap["hvd_zero_shard_bytes"]["values"][0]["count"]
    check((updates, buckets, shards) == (steps, steps * nb, steps * nb),
          f"phase 17 (b): hvd_zero_updates_total {updates}, "
          f"hvd_zero_buckets_total {buckets}, hvd_zero_shard_bytes count "
          f"{shards}; the plan's {nb} buckets over {steps} steps")
    b_in = _series_total(snap, "hvd_compression_bytes_in_total",
                         codec="int8")
    b_out = _series_total(snap, "hvd_compression_bytes_out_total",
                          codec="int8")
    gauge = _series_total(snap, "hvd_compression_ratio", codec="int8")
    check(b_out / b_in == ratio13, f"phase 17 (b): compression bytes out/in "
          f"{b_out}/{b_in} = {b_out / b_in} != phase 13's wire ratio "
          f"{ratio13}")
    check(abs(1.0 / gauge - INT8_WIRE_RATIO[0]) <= INT8_WIRE_RATIO[1],
          f"phase 17 (b): hvd_compression_ratio {gauge}")
    wire = _series_total(snap, "hvd_collective_bytes_total", codec="int8")
    check(wire == steps * wire_int8, f"phase 17 (b): "
          f"hvd_collective_bytes_total{{codec=int8}} {wire} != {steps} x "
          f"the plan's {wire_int8}")
    print(f"phase 17 (b): LM d{LM['d_model']}/L{LM['n_layers']} ZeRO-1 int8, "
          f"{steps} steps with metrics on, {res['ms_per_step']:.2f} ms/step "
          f"on {smi}: hvd_zero_updates_total {updates:.0f}, "
          f"hvd_zero_buckets_total {buckets:.0f} = {steps} x {nb} buckets; "
          f"compression bytes out/in {b_out / b_in} = phase 13's wire ratio "
          f"{ratio13}; hvd_compression_ratio (latest, the all-gather) "
          f"{gauge}; flash launches {launched}; {len(snap)} series",
          flush=True)
    torch.cuda.empty_cache()
    return launched


def phase_telemetry_attribution(smi: str) -> dict:
    """Not part of :func:`main`: phase 17 (a)'s step under
    :data:`TELEMETRY_ATTRIBUTION` (the metrics mode, each consumer alone
    and telemetry unset, twice each in turns) in one worker process;
    ms/step by mode, every loss equal across the runs."""
    got = _run_telemetry_worker(TELEMETRY_ATTRIBUTION)
    runs = got["runs"]
    for r in runs:
        check(r["losses"] == runs[0]["losses"], f"attribution: "
              f"{r['mode']}'s losses differ from {runs[0]['mode']}'s")
    by_mode: dict = {}
    for r in runs:
        by_mode.setdefault(r["mode"], []).append(r["ms_per_step"])
    print(f"phase 17 attribution on {smi}, ms/step by mode (in run "
          f"order {[r['mode'] for r in runs]}): " + json.dumps(by_mode),
          flush=True)
    return by_mode


def phase_telemetry(smi: str, main: dict, ctl: dict) -> tuple:
    """Phase 17: (a) in a worker process, phase 10's step under the three
    modes; (b) the LM's ZeRO-1 int8 step with metrics on.  Returns the
    fused-stem launches and the flash launches."""
    t_start = time.perf_counter()
    got = _run_telemetry_worker(TELEMETRY_MODES)
    out = {r["mode"]: r for r in got["runs"]}
    out["fused_stem_launches"] = got["fused_stem_launches"]
    want = main["step_losses"]
    first = out[TELEMETRY_MODES[0]]["losses"]
    summary = {}
    for mode in TELEMETRY_MODES:
        r = out[mode]
        steps = r["steps"]
        check(r["losses"] == first, f"phase 17 (a) {mode}'s losses "
              f"{r['losses']} differ from {TELEMETRY_MODES[0]}'s {first}")
        check(r["losses"][WARMUP_STEPS:] == want, f"phase 17 (a) {mode}'s "
              f"timed losses differ from phases 4 and 10's: {r['losses']} "
              f"vs {want}")
        check(r["requests"] == steps * r["gradients"], f"phase 17 (a) "
              f"{mode}: {r['requests']} requests in {steps} steps of "
              f"{r['gradients']} gradients")
        if mode == "off":
            check(r["series"] == 0 and r["spans"] == 0, f"phase 17 (a): "
                  f"telemetry unset, yet {r['series']} series and "
                  f"{r['spans']} spans")
        if mode == "metrics":
            check(r["eager_ops"] == r["requests"], f"phase 17 (a): "
                  f"hvd_eager_ops_total {r['eager_ops']} != runtime.requests "
                  f"{r['requests']}")
            check(r["fusion_buckets"] == r["allreduce_calls"], f"phase 17 "
                  f"(a): hvd_fusion_buckets_total {r['fusion_buckets']} != "
                  f"fusion.allreduce_calls {r['allreduce_calls']}")
            check(r["collective_bytes"] == steps * r["grad_bytes"],
                  f"phase 17 (a): hvd_collective_bytes_total "
                  f"{r['collective_bytes']} != {steps} x "
                  f"{r['grad_bytes']} gradient bytes")
            check(r["spans"] >= 2 * r["requests"] and r["timeline_bytes"] > 0,
                  f"phase 17 (a): {r['spans']} spans for {r['requests']} "
                  f"ops, {r['timeline_bytes']} timeline bytes")
        if mode == "schedule":
            check(r["sched_submissions"] == r["requests"]
                  and r["sched_divergences"] == 0, f"phase 17 (a): "
                  f"{r['sched_submissions']} schedule submissions for "
                  f"{r['requests']} requests, {r['sched_divergences']} "
                  f"divergences")
        summary[mode] = {
            "ms_per_step": r["ms_per_step"],
            "eager_ops_per_step": r["eager_ops"] / steps,
            "fusion_buckets_per_step": r["fusion_buckets"] / steps,
            "collective_bytes_per_step": r["collective_bytes"] / steps,
            "spans_per_step": r["spans"] / steps,
            "timeline_bytes_per_step": r["timeline_bytes"] / steps,
            "sched_submissions_per_step": r["sched_submissions"] / steps,
            "sched_divergences": r["sched_divergences"],
            "series": r["series"]}
    launches = out["fused_stem_launches"]
    n = len(TELEMETRY_MODES) * (WARMUP_STEPS + TIMED_STEPS)
    check(launches == n, f"fused_stem launched {launches} times in phase "
          f"17's {n} forward passes")
    summary["phase10_ms_per_step"] = ctl["ms_per_step"]
    summary["nvidia_smi"] = smi
    print(f"phase 17 (a): ResNet-50 s2d_fused, batch {BATCH}, through the "
          f"control plane on {smi}: telemetry unset "
          f"{summary['off']['ms_per_step']:.2f} ms/step, metrics + trace + "
          f"eager timeline {summary['metrics']['ms_per_step']:.2f}, schedule "
          f"check {summary['schedule']['ms_per_step']:.2f} (phase 10: "
          f"{ctl['ms_per_step']:.2f}); a step: "
          f"{summary['metrics']['eager_ops_per_step']:.0f} eager ops = "
          f"runtime.requests, {summary['metrics']['fusion_buckets_per_step']:.2f}"
          f" fusion buckets = fusion.allreduce_calls, "
          f"{summary['metrics']['collective_bytes_per_step']:.0f} bytes, "
          f"{summary['metrics']['spans_per_step']:.1f} spans, "
          f"{summary['metrics']['timeline_bytes_per_step']:.0f} timeline "
          f"bytes, {summary['schedule']['sched_submissions_per_step']:.0f} "
          f"schedule submissions, 0 divergences; telemetry unset leaves the "
          f"snapshot empty; every loss of the three modes equals phase 10's "
          f"bit for bit", flush=True)
    flash = _phase_telemetry_lm(smi)
    print(f"phase 17: {time.perf_counter() - t_start:.1f} s; "
          + json.dumps(summary), flush=True)
    return launches, flash


# ---------------------------------------------------------------------------
# The model zoo, ResNet remat, synchronized BatchNorm and the two lanes
# ---------------------------------------------------------------------------

def _phase_zoo_full_width(smi: str) -> dict:
    """Phase 18 (b): VGG-16, Inception-v3 and ResNet-101 at full width
    through ``run_synthetic_benchmark`` (3 warmup and 10 timed steps),
    then ``run_profile``'s category breakdown of VGG-16 and Inception-v3."""
    from horovod_tpu_torch.benchmark import run_profile, run_synthetic_benchmark

    out = {}
    for name, batch in ZOO:
        torch.cuda.empty_cache()
        res = run_synthetic_benchmark(
            name, batch_size=batch, image_size=IMAGE, input_dtype="bfloat16",
            num_warmup_batches=WARMUP_STEPS, num_batches_per_iter=1,
            num_iters=TIMED_STEPS, verbose=False)
        losses = res["step_losses"]
        check(len(losses) == TIMED_STEPS and all(
            x == x and abs(x) != float("inf") for x in losses),
            f"phase 18 (b) {name}: losses {losses}")
        keep = {k: res[k] for k in (
            "model", "batch_size_per_chip", "stem", "img_sec_total",
            "img_sec_conf", "ms_per_step", "flops_per_step",
            "tflops_per_chip", "mfu", "max_memory_allocated")}
        keep["losses"] = [losses[0], losses[-1]]
        out[name] = keep
        print(f"phase 18 (b) {name} batch {batch} {IMAGE}x{IMAGE} bf16 on "
              f"{smi}: {res['img_sec_total']:.1f} +-{res['img_sec_conf']:.1f}"
              f" img/s, {res['ms_per_step']:.2f} ms/step, MFU "
              f"{res['mfu'] * 100:.2f}% ({res['flops_per_step'] / 1e12:.3f} "
              f"TFLOP a step over 989 TFLOP/s), peak "
              f"{res['max_memory_allocated']} bytes; losses finite, "
              f"{losses[0]:.5f} -> {losses[-1]:.5f}", flush=True)
        del res
    batches = dict(ZOO)
    for name in ZOO_PROFILED:
        torch.cuda.empty_cache()
        layered = name == ZOO_LAYERED
        prof = run_profile(name, batches[name], image_size=IMAGE,
                           steps=ZOO_PROFILE_STEPS, top=8, layers=layered)
        out[name]["profile"] = {k: prof[k] for k in (
            "wall_ms_per_step", "kernel_ms_per_step", "device_busy_share",
            "kernels_per_step", "ms_per_step_by_category",
            "top_kernels_ms_per_step")}
        print(f"phase 18 (b) profile {name}: "
              + json.dumps(out[name]["profile"]), flush=True)
        if layered:
            lay = prof["layers"]
            other, untracked = lay["other_share"], lay["untracked_share"]
            check(other <= ZOO_OTHER_SHARE
                  and untracked <= ZOO_UNTRACKED_SHARE,
                  f"phase 18 (b) {name}: by_layer put {other:.4g} of the "
                  f"kernel time in no layer and {untracked:.4g} in kernels "
                  f"whose launch it did not find (limits {ZOO_OTHER_SHARE}, "
                  f"{ZOO_UNTRACKED_SHARE})")
            out[name]["profile"]["layers"] = lay
            print(f"phase 18 (b) {name} by layer (a trace of its own with "
                  f"module scopes): {lay['layer_total_ms_per_step']:.3f} ms "
                  f"of kernels a step, {other!r} of it in no layer (limit "
                  f"{ZOO_OTHER_SHARE}), {untracked!r} untracked (limit "
                  f"{ZOO_UNTRACKED_SHARE}); top five [layer, direction, ms "
                  f"a step]: " + json.dumps(lay["top_ms_per_step"][:5]),
                  flush=True)
    torch.cuda.empty_cache()
    return out


def _resnet50_run(remat=None, axis_name=None) -> dict:
    """Phase 4's ResNet-50 ``s2d_fused`` step (same seed, batch, input and
    SGD), under ``remat`` or with BatchNorm synchronized over
    ``axis_name``, for phase 4's warmup and timed steps: the timed losses,
    ms/step, peak memory, the final running statistics and the fused-stem
    launches and statistics all-reduces of the run."""
    from horovod_tpu_torch.benchmark import make_bench_state, make_train_step
    from horovod_tpu_torch.models import get_model, resnet
    from horovod_tpu_torch.models.convert import flax_ordered_parameters
    from horovod_tpu_torch.ops import fused_stem

    torch.cuda.empty_cache()
    st = make_bench_state("resnet50", batch_size=BATCH, image_size=IMAGE,
                          stem="s2d_fused", input_dtype="bfloat16",
                          remat=remat)
    if axis_name is not None:
        model = get_model("resnet50", num_classes=1000, stem="s2d_fused",
                          axis_name=axis_name, remat=remat,
                          device=st.mesh.device,
                          generator=torch.Generator().manual_seed(0))
        opt = torch.optim.SGD([p for _, p in flax_ordered_parameters(model)],
                              lr=0.01, momentum=0.9)
        st = st._replace(model=model, optimizer=opt)
    step = make_train_step(st.model, st.optimizer, st.mesh, st.axis)
    fused_stem.launches.reset()
    resnet.stats_allreduce_calls.reset()
    for _ in range(WARMUP_STEPS):
        step(st.images, st.labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    losses = [step(st.images, st.labels) for _ in range(TIMED_STEPS)]
    t1.record()
    torch.cuda.synchronize()
    out = {"losses": [float(x) for x in losses],
           "ms_per_step": t0.elapsed_time(t1) / TIMED_STEPS,
           "peak": torch.cuda.max_memory_allocated(),
           "stats": [b.detach().clone() for b in st.model.buffers()],
           "stem_launches": fused_stem.launches.count,
           "stats_allreduces": resnet.stats_allreduce_calls.count}
    del st, step
    torch.cuda.empty_cache()
    return out


def phase_zoo_and_lanes(smi: str, main: dict) -> int:
    """Phase 18: (a) small VGG and Inception steps, card against the CPU;
    (b) VGG-16, Inception-v3 and ResNet-101 at full width with profiles;
    (c) phase 4's step under remat "lean" and "full"; (d) with BatchNorm
    synchronized over the NCCL group of size 1, alone and under each
    remat; (e) the step-guard lane;
    (f) across cards, the scaling-efficiency lane and a synchronized step
    over NCCL against gloo.  Returns the fused-stem launches of (c), (d)
    and (e)."""
    from horovod_tpu_torch.benchmark import run_step_guard_benchmark
    from horovod_tpu_torch.ops import fused_stem

    t_start = time.perf_counter()
    avg_pool_check()
    phase_reference(SMALL_ZOO, "phase 18 (a)")
    zoo = _phase_zoo_full_width(smi)

    steps = WARMUP_STEPS + TIMED_STEPS
    want = main["step_losses"]
    base = _resnet50_run()
    runs = {"none": base}
    for remat in REMATS:
        runs[remat] = _resnet50_run(remat=remat)
    runs["sync"] = _resnet50_run(axis_name="data")
    for remat in REMATS:
        runs["sync " + remat] = _resnet50_run(remat=remat, axis_name="data")
    for label, r in runs.items():
        check(r["losses"] == want, f"phase 18 {label}: timed losses "
              f"{r['losses']} differ from phase 4's {want}")
        check(all(torch.equal(a, b) for a, b in zip(r["stats"],
                                                    base["stats"])),
              f"phase 18 {label}: final running statistics differ from "
              f"remat=None's")
        check(r["stem_launches"] == steps, f"phase 18 {label}: fused_stem "
              f"launched {r['stem_launches']} times in {steps} steps")
    for label, r in runs.items():
        want_calls = RESNET50_BN_LAYERS * steps if "sync" in label else 0
        check(r["stats_allreduces"] == want_calls, f"phase 18 {label}: "
              f"{r['stats_allreduces']} statistics all-reduces in {steps} "
              f"steps; expected {want_calls}")
    sync = runs["sync"]
    for label in REMATS:
        r = runs[label]
        print(f"phase 18 (c) ResNet-50 s2d_fused batch {BATCH} "
              f"remat={label!r} on {smi}: {r['ms_per_step']:.2f} ms/step, "
              f"peak {r['peak']} bytes (remat=None here: "
              f"{base['ms_per_step']:.2f} ms/step, peak {base['peak']} "
              f"bytes; phase 4: {main['ms_per_step']:.2f} ms/step, peak "
              f"{main['max_memory_allocated']} bytes); the {TIMED_STEPS} "
              f"timed losses equal phase 4's and the final running "
              f"statistics remat=None's bit for bit; fused_stem "
              f"{r['stem_launches']} launches in {steps} steps", flush=True)
    print(f"phase 18 (d) ResNet-50 s2d_fused batch {BATCH}, BatchNorm "
          f"synchronized over the NCCL group of size 1, on {smi}: "
          f"{sync['ms_per_step']:.2f} ms/step (remat=None: "
          f"{base['ms_per_step']:.2f}); {sync['stats_allreduces'] // steps}"
          f" statistics all-reduces a step (one per BatchNorm); timed "
          f"losses equal phase 4's and the final statistics remat=None's "
          f"bit for bit", flush=True)
    for label in REMATS:
        r = runs["sync " + label]
        print(f"phase 18 (d) the same under remat={label!r}: "
              f"{r['ms_per_step']:.2f} ms/step, peak {r['peak']} bytes; "
              f"{r['stats_allreduces'] // steps} statistics all-reduces a "
              f"step (none in a recompute); timed losses equal phase 4's "
              f"and the final statistics remat=None's bit for bit",
              flush=True)

    fused_stem.launches.reset()
    guard = run_step_guard_benchmark(
        "resnet50", BATCH, image_size=IMAGE, stem="s2d_fused",
        input_dtype="bfloat16", num_warmup_batches=WARMUP_STEPS,
        num_batches_per_iter=1, num_iters=TIMED_STEPS, verbose=False)
    guard_launches = fused_stem.launches.count
    check(guard_launches == 2 * steps, f"phase 18 (e): fused_stem launched "
          f"{guard_launches} times in two runs of {steps} steps")
    print(f"phase 18 (e) step guard ResNet-50 s2d_fused batch {BATCH} on "
          f"{smi}: overhead {guard['value']:.3f}% ({guard['baseline_img_sec']}"
          f" -> {guard['guarded_img_sec']} img/s; not gated)", flush=True)
    phase_zoo_processes(smi)
    summary = {"zoo": zoo, "step_guard": guard, "nvidia_smi": smi}
    summary.update({label: {k: r[k] for k in (
        "ms_per_step", "peak", "stats_allreduces")}
        for label, r in runs.items()})
    print(f"phase 18: {time.perf_counter() - t_start:.1f} s; "
          + json.dumps(summary), flush=True)
    return sum(r["stem_launches"] for r in runs.values()) + guard_launches


def _scaling_worker(rank, size, addr, out_dir):
    import os

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.benchmark import run_scaling_efficiency

    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=addr)
    hvd.init()
    try:
        res = run_scaling_efficiency(
            "resnet50", BATCH, image_size=IMAGE, stem="s2d_fused",
            input_dtype="bfloat16", num_warmup_batches=WARMUP_STEPS,
            num_batches_per_iter=1, num_iters=TIMED_STEPS, verbose=False)
        torch.save(res, f"{out_dir}/scaling{rank}.pt")
    finally:
        hvd.shutdown()


def run_scaling_processes(size: int, out_dir: str) -> dict:
    """``run_scaling_efficiency`` for phase 4's ResNet-50 ``s2d_fused``
    step on ``size`` NCCL ranks, one card a rank; rank 0's dict, checked
    to be every rank's."""
    _spawn(_scaling_worker, size, (), out_dir)
    got = [torch.load(f"{out_dir}/scaling{r}.pt") for r in range(size)]
    check(all(g == got[0] for g in got), f"scaling efficiency differs "
          f"across ranks: {got}")
    res = got[0]
    check(res["n_devices"] == size and res["n_baseline_devices"] == 1
          and 0 < res["scaling_efficiency"] <= 1.5,
          f"scaling efficiency on {size} NCCL ranks: {res}")
    return res


def _sync_bn_worker(rank, size, addr, backend, out_dir):
    import os

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.benchmark import make_train_step
    from horovod_tpu_torch.models.resnet import BasicBlock, ResNet

    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=addr)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init(device=None if backend == "nccl" else "cpu")
    try:
        dev = hvd.device()
        model = ResNet(stage_sizes=[1, 1], block_cls=BasicBlock,
                       num_classes=5, num_filters=16, stem="s2d_fused",
                       dtype=torch.float32, axis_name="data",
                       generator=torch.Generator().manual_seed(0),
                       device=dev)
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        step = make_train_step(model, opt, hvd.mesh())
        g = torch.Generator().manual_seed(3)
        images = torch.randn(4 * size, 8, 8, 12, generator=g)
        labels = torch.randint(0, 5, (4 * size,), generator=g)
        rows = slice(4 * rank, 4 * rank + 4)
        losses = [float(step(images[rows].to(dev), labels[rows].to(dev)))
                  for _ in range(2)]
        torch.save({"losses": losses, "state": _state_vector(model)},
                   f"{out_dir}/{backend}{rank}.pt")
    finally:
        hvd.shutdown()


def run_sync_bn_step(backend: str, size: int, out_dir: str) -> list:
    """Two steps of a small ResNet whose BatchNorms average over ``size``
    ranks of ``backend`` (NCCL: one card a rank; gloo: the CPU)."""
    _spawn(_sync_bn_worker, size, (backend,), out_dir)
    return [torch.load(f"{out_dir}/{backend}{r}.pt") for r in range(size)]


def compare_sync_bn_step(nccl: list, gloo: list) -> dict:
    """Phase 5's limits between the backends on every rank; each backend's
    state one value on every rank (the statistics are synchronized, the
    gradients averaged)."""
    worst_loss, worst_state = 0.0, 0.0
    for a, b in zip(nccl, gloo):
        for x, y in zip(a["losses"], b["losses"]):
            worst_loss = max(worst_loss, abs(x - y) / max(1.0, abs(y)))
        worst_state = max(worst_state,
                          (a["state"] - b["state"]).abs().max().item())
    for runs in (nccl, gloo):
        check(all(torch.equal(r["state"], runs[0]["state"]) for r in runs),
              "synchronized-BN state differs across ranks")
    check(worst_loss <= SMALL_LOSS_RTOL and worst_state <= SMALL_STATE_ATOL,
          f"synchronized-BN steps nccl vs gloo: loss {worst_loss:.3g}, "
          f"state {worst_state:.3g}")
    return {"loss_rel": worst_loss, "state_abs": worst_state}


def phase_zoo_processes(smi: str) -> None:
    """Phase 18 (f): the lanes across NCCL processes, where the host has
    the cards for them."""
    import tempfile

    n = torch.cuda.device_count()
    if n < 2:
        print(f"phase 18 (f) did not run: {n} CUDA device here, and the "
              f"scaling-efficiency lane and a synchronized-BN step across "
              f"NCCL processes need one card a rank (NCCL refuses two ranks "
              f"on one card)", flush=True)
        return
    size = min(n, 4)
    with tempfile.TemporaryDirectory() as out:
        res = run_scaling_processes(size, out)
        nccl = run_sync_bn_step("nccl", size, out)
        gloo = run_sync_bn_step("gloo", size, out)
    sync = compare_sync_bn_step(nccl, gloo)
    print(f"phase 18 (f) on {size} cards ({smi}): ResNet-50 s2d_fused batch "
          f"{BATCH} a rank, weak-scaling efficiency "
          f"{res['scaling_efficiency'] * 100:.2f}% ({res['img_sec_1']:.1f} "
          f"img/s on {res['n_baseline_devices']} rank, {res['img_sec_n']:.1f}"
          f" on {res['n_devices']}); two synchronized-BN steps of a small "
          f"ResNet over NCCL against gloo: " + json.dumps(sync), flush=True)


# ---------------------------------------------------------------------------
# The serving plane on the card
# ---------------------------------------------------------------------------

SERVING_VOCAB = 50257          # serving/model.py's ToyModel.VOCAB
SERVING_WEIGHTS = ("integer", "seeded normal")
SERVING_DECODE_BATCH = 8
SERVING_DECODE_RUNS = 200
SERVING_KEY = b"chip-smoke-serving-key-0123456789"


def _serving_weights(label: str):
    import numpy as np

    if label == "integer":
        return np.arange(8, dtype=np.float32) + 100.0
    return (np.random.default_rng(5).standard_normal(4096)
            .astype(np.float32) * 37.25)


def _toy_plain(batch, weights) -> list:
    """The decode contract in plain Python: ``(31*tok + 7*pos + c) %
    vocab`` with ``c`` the reference's checksum (numpy's float32 sum)."""
    import numpy as np

    c = int(abs(float(np.asarray(weights, np.float32).sum()))) % \
        SERVING_VOCAB
    return [(31 * int(t) + 7 * int(p) + c) % SERVING_VOCAB
            for t, p in batch]


def _toy_stream(prompt: int, n: int, weights, start: int = 0) -> list:
    tok, out = prompt, []
    for pos in range(start, start + n):
        tok = _toy_plain([(tok, pos)], weights)[0]
        out.append(tok)
    return out


def _host_ms(fn, runs: int) -> float:
    """Median host milliseconds of ``fn()`` (which ends in a device to
    host read, so it waits for the card)."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _with_fault_spec(spec: str, fn):
    """Run ``fn()`` with HOROVOD_FAULT_SPEC set in this process, then put
    the variable back and forget the parsed plan either way."""
    import os

    from horovod_tpu_torch import faults

    old = os.environ.get(faults.ENV_VAR)
    os.environ[faults.ENV_VAR] = spec
    faults.reset()
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop(faults.ENV_VAR, None)
        else:
            os.environ[faults.ENV_VAR] = old
        faults.reset()


def _serving_streams(router, tenants, n: int, tokens: int) -> dict:
    hs = {}
    for i in range(n):
        tenant = tenants[i % len(tenants)]
        hs[i] = router.submit(tenant, 40 + i, max_new_tokens=tokens,
                              request_id=f"{tenant}-{i}")
    return hs


def phase_serving(smi: str) -> dict:
    """Phase 19: (a) the decode contract on the card; (b) a hot update
    through broadcast_weights on the NCCL group of size 1 and a router
    over two in-process replicas; (c) the RPC plane on localhost, a
    replica crash and a request storm; (d) a replica loaded from a
    checkpoint; (e) the serving lane on the card and on the CPU."""
    import os
    import shutil
    import tempfile

    import numpy as np

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint
    from horovod_tpu_torch.benchmark import run_serving_benchmark
    from horovod_tpu_torch.serving import (LocalReplicaHandle, ReplicaWorker,
                                           Router, RpcReplicaHandle,
                                           TenantConfig, ToyModel,
                                           broadcast_weights,
                                           load_replica_model)

    t_start = time.perf_counter()
    hvd.init()
    out = {"nvidia_smi": smi}

    # (a) Equal streams on the card and in plain Python.
    rng = np.random.default_rng(19)
    for label in SERVING_WEIGHTS:
        w = _serving_weights(label)
        m = ToyModel(w, device="cuda")
        check(m.get_weights().is_cuda, "phase 19 (a): weights not on the card")
        for _ in range(8):
            n = int(rng.integers(1, 17))
            batch = list(zip(rng.integers(0, 10 ** 6, n).tolist(),
                             rng.integers(0, 8192, n).tolist()))
            got = m.decode_step(batch)
            check(got == _toy_plain(batch, w) and all(
                type(t) is int for t in got),
                f"phase 19 (a) {label} weights: {got} against "
                f"{_toy_plain(batch, w)}")
    batch = list(zip(range(SERVING_DECODE_BATCH),
                     range(100, 100 + SERVING_DECODE_BATCH)))
    card, host = ToyModel(device="cuda"), ToyModel(device="cpu")
    out["decode_step_ms"] = {
        "cuda": _host_ms(lambda: card.decode_step(batch),
                         SERVING_DECODE_RUNS),
        "cpu": _host_ms(lambda: host.decode_step(batch),
                        SERVING_DECODE_RUNS)}
    print(f"phase 19 (a) ToyModel on {smi}: streams equal to the plain "
          f"formula for {len(SERVING_WEIGHTS)} weight vectors (integer and "
          f"non-integer) x 8 seeded batches; one decode_step of "
          f"{SERVING_DECODE_BATCH} sequences "
          f"{out['decode_step_ms']['cuda']:.4f} ms on the card, "
          f"{out['decode_step_ms']['cpu']:.4f} ms with device='cpu' "
          f"(host clock, median of {SERVING_DECODE_RUNS}; not gated)",
          flush=True)

    # (b) The broadcast plane, then a hot update mid-stream.
    new_w = np.arange(8, dtype=np.float32) * 3.0 + 7.0
    got_w, gen = broadcast_weights(new_w, 1)
    check(gen == 1 and got_w.is_cuda and got_w.dtype == torch.float32
          and np.array_equal(got_w.cpu().numpy(), new_w),
          f"phase 19 (b): broadcast_weights gave generation {gen}, "
          f"{got_w.device} {got_w.dtype}")
    workers = [ReplicaWorker(ToyModel(device="cuda"), replica_id=f"r{i}")
               for i in range(2)]
    tenants = ("alice", "bob")
    router = Router([LocalReplicaHandle(w) for w in workers],
                    [TenantConfig(t, quota=64, slo_ms=0.0) for t in tenants],
                    max_batch=4)
    hs = _serving_streams(router, tenants, 8, 8)    # every slot of both
    while any(len(h.tokens) < 3 for h in hs.values()):
        router.step()
    check(all(len(h.tokens) == 3 for h in hs.values()),
          "phase 19 (b): the streams did not run side by side")
    pause = {i: list(h.tokens) for i, h in hs.items()}
    check(router.push_weights(got_w, gen) == 2,
          "phase 19 (b): push_weights reached fewer than 2 replicas")
    router.drain()
    check(router.dropped == 0, f"phase 19 (b): {router.dropped} dropped")
    for i, h in hs.items():
        head = pause[i]
        want = head + _toy_stream(head[-1], 8 - len(head), new_w, len(head))
        check(h.completed and h.tokens == want,
              f"phase 19 (b) stream {i}: {h.tokens} did not flip at its "
              f"pause point ({want})")
    check(all(w.model.generation == 1 for w in workers),
          "phase 19 (b): a replica did not apply generation 1")
    print(f"phase 19 (b) broadcast_weights over {hvd.size()} NCCL rank: "
          f"generation 1 and the weights unchanged, on {got_w.device}; "
          f"router over 2 replicas on the card, 2 tenants, 8 streams of 8 "
          f"tokens, push_weights mid-stream: every stream flips at its "
          f"pause point, 0 dropped, {router.completed} completed",
          flush=True)

    # (c) The RPC plane on localhost.
    rpc_workers = [ReplicaWorker(ToyModel(device="cuda"), replica_id=f"q{i}")
                   for i in range(2)]
    servers = [w.attach(SERVING_KEY) for w in rpc_workers]
    try:
        handles = [RpcReplicaHandle("127.0.0.1", s.port, SERVING_KEY,
                                    timeout=30.0) for s in servers]
        h0 = handles[0]
        check(h0.ping() == {"ok": True, "replica": "q0", "generation": 0},
              "phase 19 (c): ping")
        r = h0.decode([("p", 5, 0), ("q", 6, 1)])
        check(r["tokens"] == {"p": _toy_plain([(5, 0)], np.arange(
            8, dtype=np.float32))[0], "q": _toy_plain([(6, 1)], np.arange(
                8, dtype=np.float32))[0]}, f"phase 19 (c): decode {r}")
        h0.update_weights(got_w, 2)            # a card tensor, sent as host
        r = h0.decode([("p", 5, 0)])
        check(r["generation"] == 2 and r["tokens"]["p"] == _toy_plain(
            [(5, 0)], new_w)[0], f"phase 19 (c): after update {r}")
        check(rpc_workers[0].model.get_weights().is_cuda,
              "phase 19 (c): the update did not land on the card")
        st = h0._call({"kind": "stats"})
        check(st["decode_steps"] == 2 and not st["dead"],
              f"phase 19 (c): stats {st}")
        wrong = RpcReplicaHandle("127.0.0.1", servers[1].port, b"w" * 32,
                                 timeout=5.0)
        try:
            wrong.ping()
            refused = False
        except (ConnectionError, OSError):
            refused = True
        check(refused, "phase 19 (c): a wrong key was answered")
        h0.update_weights(np.arange(8, dtype=np.float32), 0)
        clean = Router([LocalReplicaHandle(ReplicaWorker(
            ToyModel(device="cuda"))) for _ in range(2)],
            [TenantConfig(t, quota=64, slo_ms=0.0) for t in tenants],
            max_batch=4)
        want = _serving_streams(clean, tenants, 8, 6)
        clean.drain()
        router = Router(handles, [TenantConfig(t, quota=64, slo_ms=0.0)
                                  for t in tenants], max_batch=4)

        def crashed():
            hs = _serving_streams(router, tenants, 8, 6)
            router.drain()
            return hs

        hs = _with_fault_spec("site=serving,kind=replica_crash,after=3",
                              crashed)
        dead = [w.replica_id for w in rpc_workers if w._dead]
        check(len(dead) == 1 and sum(not h.healthy for h in handles) == 1,
              f"phase 19 (c): dead replicas {dead}")
        check(router.dropped == 0 and all(
            hs[i].tokens == want[i].tokens for i in hs),
            "phase 19 (c): the retried streams differ from the clean ones")

        def storm():
            r = Router([LocalReplicaHandle(ReplicaWorker(
                ToyModel(device="cuda")))], [TenantConfig("alice")],
                max_batch=8)
            r.step()
            queued = r.stats()["queue_depth"] + r.stats()["inflight"]
            r.drain()
            return r, queued

        storm_router, storm_load = _with_fault_spec(
            "site=serving,kind=request_storm:6", storm)
        check("storm" in storm_router._tenants and storm_load == 6
              and storm_router.completed == 6,
              f"phase 19 (c): the storm added {storm_load} requests, "
              f"{storm_router.completed} completed")
    finally:
        for s in servers:
            s.shutdown()
    print(f"phase 19 (c) RPC plane on 127.0.0.1: ping, stats, decode and "
          f"update_weights answered (the weights sent from the card as a "
          f"host array, applied on the card), a wrong key refused; "
          f"replica_crash after 3 decodes killed {dead[0]}, the router "
          f"failed over with 0 dropped and 8 streams equal to a clean "
          f"run's; request_storm:6 queued 6 requests under the storm "
          f"tenant, all completed", flush=True)

    # (d) A replica from a checkpoint.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    try:
        ckpt_w = np.arange(8, dtype=np.float32) * 0.5 + 11.0
        check(checkpoint.save(tmp, {"w": ckpt_w}, step=12) is not None,
              "phase 19 (d): checkpoint.save failed")
        m = load_replica_model(tmp, device="cuda")
        check(m.generation == 12 and m.get_weights().is_cuda and
              np.array_equal(m.get_weights().cpu().numpy(), ckpt_w) and
              m.decode_step([(3, 4)]) == _toy_plain([(3, 4)], ckpt_w),
              f"phase 19 (d): generation {m.generation}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not os.path.exists(tmp), "phase 19 (d): files left behind")
    print("phase 19 (d) load_replica_model: a checkpoint saved at step 12 "
          "loads on the card as generation 12 with its weights; files "
          "deleted", flush=True)

    # (e) The serving lane, card against CPU.
    lane = run_serving_benchmark(device="cuda")
    cpu_lane = run_serving_benchmark(device="cpu")
    check(lane["rows"] == cpu_lane["rows"],
          "phase 19 (e): the lane's rows differ between card and CPU")
    out["lane_rows"] = lane["rows"]
    print("phase 19 (e) serving lane rows (virtual clock, card equal to "
          "CPU): " + json.dumps(lane["rows"]), flush=True)
    out["seconds"] = time.perf_counter() - t_start
    print(f"phase 19: {out['seconds']:.1f} s; " + json.dumps(out),
          flush=True)
    return out


# Phase 20 (a): the main path through the port's launcher.
LAUNCH_WARMUP = 2
LAUNCH_ITERS = 3
# Phase 20 (c): the two-level eager plane at 2 x 2 on gloo.
HIER_SIZES = (1, 7, 100_003, 1_000_003)


def _launcher(args, env=None, timeout=600, wait=True):
    """``python -m horovod_tpu_torch.runner ARGS`` from the repo's root:
    its ``CompletedProcess``, or with ``wait=False`` the running process
    (its output in temporary files it holds as ``out``/``err``)."""
    import os
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    full = dict(os.environ)
    full["PYTHONPATH"] = root + os.pathsep + full.get("PYTHONPATH", "")
    full.update(env or {})
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", *args]
    if wait:
        return subprocess.run(cmd, cwd=root, env=full, capture_output=True,
                              text=True, timeout=timeout)
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(cmd, cwd=root, env=full, stdout=out, stderr=err,
                            text=True)
    proc.out, proc.err = out, err
    return proc


def _hier_worker(out_dir: str) -> None:
    """Phase 20 (c)'s rank: CPU tensors on gloo, 2 hosts of 2; the sizes
    flat, then through the two-level plane at threshold 0 after a re-init
    at a fresh rendezvous."""
    import os

    import numpy as np

    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)
    rank = int(os.environ["HOROVOD_RANK"])
    os.environ["HOROVOD_LOCAL_SIZE"] = "2"
    os.environ["HOROVOD_LOCAL_RANK"] = str(rank % 2)
    out = {}
    for mode in ("flat", "hier"):
        if mode == "hier":
            port = hvd.broadcast_object(
                hvd.basics._free_localhost_port() if rank == 0 else None, 0)
            hvd.shutdown()
            os.environ["HOROVOD_COORDINATOR_ADDR"] = f"127.0.0.1:{port}"
            os.environ.update(HOROVOD_HIERARCHICAL_ALLREDUCE="1",
                              HOROVOD_HIERARCHICAL_ALLGATHER="1",
                              HOROVOD_HIERARCHICAL_ALLREDUCE_THRESHOLD="0")
        hvd.init(device="cpu")
        rt = hvd.basics.runtime()
        out[f"{mode}/enabled"] = torch.tensor(
            [rt.hierarchical_enabled(), rt.hierarchical_allgather_enabled()])
        for n in HIER_SIZES:
            g = np.random.default_rng(1000 * rank + n)
            x = torch.from_numpy(g.integers(-50, 50, n).astype(np.float32))
            out[f"{mode}/ar/{n}"] = hvd.allreduce(x, op=hvd.Sum,
                                                  name=f"ar.{n}")
            out[f"{mode}/ag/{n}"] = hvd.allgather(x[:max(n - 3 * rank, 1)],
                                                  name=f"ag.{n}")
        c = rt.hier_counters
        out[f"{mode}/bytes"] = torch.tensor(
            [c["flat_allreduce_bytes"], c["hier_cross_bytes"],
             c["hier_allreduce_ops"], c["hier_ag_ops"]])
    hvd.shutdown()
    torch.save(out, os.path.join(out_dir, f"hier{rank}.pt"))


def phase_launcher(smi: str, main: dict) -> int:
    """Phase 20; returns (a)'s fused-stem launches.  (c) runs on the CPU
    while (a) and (b) run."""
    finish_hierarchical = _launcher_hierarchical()
    launches = _launcher_main_path(main)
    _launcher_check_build()
    finish_hierarchical()
    return launches


def _launcher_main_path(main: dict) -> int:
    """Phase 20 (a): the main path through the launcher, its metrics
    plane on; returns the fused-stem launches the rank reported."""
    import os
    import re
    import tempfile

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        metrics = os.path.join(tmp, "metrics.json")
        t0 = time.perf_counter()
        p = _launcher(["-np", "1", "--metrics-file", metrics, sys.executable,
                       "-m", "horovod_tpu_torch.benchmark", "--model",
                       "resnet50", "--batch-size", str(BATCH),
                       "--image-size", str(IMAGE), "--stem", "s2d_fused",
                       "--input-dtype", "bfloat16", "--num-warmup-batches",
                       str(LAUNCH_WARMUP), "--num-batches-per-iter", "1",
                       "--num-iters", str(LAUNCH_ITERS)])
        seconds = time.perf_counter() - t0
        check(p.returncode == 0, f"phase 20 (a): the launcher's job exited "
              f"{p.returncode}:\n{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        m = re.search(r"^\[0\]<stdout>:RESULT (\{.*\})$", p.stdout, re.M)
        check(m is not None, f"phase 20 (a): no RESULT line:\n"
              f"{p.stdout[-3000:]}")
        res = json.loads(m.group(1))
        check(res["platform"] == "gpu"
              and res["device"] == torch.cuda.get_device_name(0),
              f"phase 20 (a): the rank ran on {res['device']} "
              f"({res['platform']}), not the card")
        with open(metrics) as f:
            doc = json.load(f)
        rank0 = doc["ranks"]["0"]["metrics"].get("hvd_kernel_launches", {})
        stem = [v["value"] for v in rank0.get("values", [])
                if v["labels"].get("kernel") == "fused_stem"]
        steps = LAUNCH_WARMUP + LAUNCH_ITERS
        check(stem == [float(steps)],
              f"phase 20 (a): fused_stem launches in the metrics file "
              f"{stem}, expected [{steps}] (one a forward pass)")
    print(f"phase 20 (a): launcher job rc 0 in {seconds:.1f} s on "
          f"{res['device']}; fused_stem launches {int(stem[0])} (metrics "
          f"file); {res['img_sec_total']:.1f} img/s, "
          f"{res['ms_per_step']:.2f} ms/step beside phase 4's "
          f"{main['img_sec_total']:.1f} img/s, {main['ms_per_step']:.2f} "
          f"ms/step (not gated)", flush=True)
    return int(stem[0])


def _launcher_check_build() -> None:
    """Phase 20 (b): the build report lists NCCL."""
    p = _launcher(["--check-build"], timeout=120)
    check(p.returncode == 0 and "[X] NCCL" in p.stdout,
          f"phase 20 (b): --check-build rc {p.returncode}, no '[X] NCCL':\n"
          f"{p.stdout}{p.stderr[-2000:]}")
    print("phase 20 (b): --check-build: " + "; ".join(
        line.strip() for line in p.stdout.splitlines()
        if line.strip().startswith("[")), flush=True)


def _launcher_hierarchical():
    """Phase 20 (c): the two-level eager plane at 2 x 2 on gloo.  Starts
    the job and returns the function that waits for it and checks it."""
    import os
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp()
    t0 = time.perf_counter()
    proc = _launcher(["-np", "4", sys.executable, os.path.abspath(__file__),
                      "--hier-worker", tmp], env={"OMP_NUM_THREADS": "1"},
                     wait=False)

    def finish() -> None:
        try:
            rc = proc.wait(timeout=300)
            seconds = time.perf_counter() - t0
            proc.out.seek(0)
            proc.err.seek(0)
            check(rc == 0, f"phase 20 (c): the 4-rank job exited {rc}:\n"
                  f"{proc.out.read()[-3000:]}\n{proc.err.read()[-3000:]}")
            ranks = [torch.load(os.path.join(tmp, f"hier{r}.pt"))
                     for r in range(4)]
        finally:
            proc.kill()
            proc.out.close()
            proc.err.close()
            shutil.rmtree(tmp, ignore_errors=True)
        for r, res in enumerate(ranks):
            check(res["flat/enabled"].tolist() == [False, False]
                  and res["hier/enabled"].tolist() == [True, True],
                  f"phase 20 (c): rank {r} enabled flags "
                  f"{res['flat/enabled']}, {res['hier/enabled']}")
            for n in HIER_SIZES:
                for kind in ("ar", "ag"):
                    check(torch.equal(res[f"hier/{kind}/{n}"],
                                      res[f"flat/{kind}/{n}"]),
                          f"phase 20 (c): rank {r} {kind} at {n} differs "
                          f"from the flat plane's")
        flat = sum(int(res["flat/bytes"][0]) for res in ranks)
        cross = sum(int(res["hier/bytes"][1]) for res in ranks)
        check(flat > 0 and 2 * cross == flat,
              f"phase 20 (c): cross bytes {cross} are not half the flat "
              f"bytes {flat}")
        print(f"phase 20 (c): 4 gloo ranks as 2 x 2 in {seconds:.1f} s "
              f"(beside (a) and (b)): allreduce and allgather at "
              f"{list(HIER_SIZES)} bit for bit the flat plane's, "
              f"hierarchical_enabled() on every rank, cross bytes {cross} = "
              f"flat {flat} / 2", flush=True)

    return finish


# Phase 21 (a): the fleet on the one card.  low runs phase 4's 13 steps
# (WARMUP_STEPS + TIMED_STEPS), so its losses from step 3 on are phase
# 4's timed ones; its first attempt waits at FLEET_LOW_HOLD for the
# preemption (at most FLEET_HOLD_S), so the preemption lands mid-run.
FLEET_LOW_STEPS = WARMUP_STEPS + TIMED_STEPS
FLEET_LOW_HOLD = 4
FLEET_HOLD_S = 300.0
FLEET_HIGH_AFTER = 25.0
FLEET_STARVATION = 2.0
FLEET_LM_STEPS = (1, 1)          # (warm-up, timed) steps of high
# Phase 21 (b): the crash-and-restart job on gloo.
CHAOS_STEPS = 5
CHAOS_SPEC = "rank=1,site=allreduce,after=3,kind=crash,attempt=0"
# A job's command: a SIGTERM that lands while torch still imports is
# noted, and the worker acts on it at its first step boundary.
_FLEET_STUB = ("import os, signal, sys; early = []; "
               "signal.signal(signal.SIGTERM, lambda s, f: early.append(s));"
               " sys.path.insert(0, {root!r}); import chip_smoke; "
               "chip_smoke._fleet_worker({job!r}, {out!r}, early)")


def _fleet_worker(job: str, out_dir: str, early: list) -> None:
    """A job of phase 21 (a), one attempt: its metrics file is
    ``<job>.attempt<N>.json`` under ``out_dir``."""
    import os

    attempt = os.environ.get("HOROVOD_RESTART_ATTEMPT", "0")
    os.environ["HOROVOD_METRICS_FILE"] = os.path.join(
        out_dir, f"{job}.attempt{attempt}.json")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import resilience

    hvd.init()
    resilience.install_preemption_handler()
    if early:
        resilience.request_preemption()
    on = hvd.device()
    print("FLEET_DEVICE " + json.dumps({
        "job": job, "attempt": attempt, "local_rank": hvd.local_rank(),
        "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "platform": "gpu" if on.type == "cuda" else on.type,
        "device": (torch.cuda.get_device_name(on) if on.type == "cuda"
                   else "cpu")}), flush=True)
    if job == "low":
        _fleet_low(out_dir, attempt)
    else:
        _fleet_high()
    hvd.shutdown()


def _fleet_low(out_dir: str, attempt: str) -> None:
    import os

    from horovod_tpu_torch import benchmark, checkpoint, resilience

    st = benchmark.make_bench_state("resnet50", BATCH, image_size=IMAGE,
                                    input_dtype="bfloat16",
                                    stem="s2d_fused")
    step = benchmark.make_train_step(st.model, st.optimizer, st.mesh,
                                     st.axis)
    params = [p for g in st.optimizer.param_groups for p in g["params"]]
    ckpt = os.path.join(out_dir, "low_ckpt")

    def state(n):
        return {"model": dict(st.model.state_dict()),
                "momentum": [st.optimizer.state[p].get(
                    "momentum_buffer", torch.zeros_like(p)) for p in params],
                "step": n}

    start = 0
    if checkpoint.latest_step(ckpt) is not None:
        back = checkpoint.restore(ckpt, state(0))
        with torch.no_grad():
            st.model.load_state_dict(back["model"])
        for p, m in zip(params, back["momentum"]):
            st.optimizer.state[p]["momentum_buffer"] = m.to(p.device).clone()
        start = int(back["step"])
        print(f"FLEET_RESUME job=low start={start} prev_np="
              f"{os.environ.get('HOROVOD_ELASTIC_PREV_SIZE', '')}",
              flush=True)
    for i in range(start, FLEET_LOW_STEPS):
        loss = float(step(st.images, st.labels))
        print(f"FLEET_LOSS step={i} {loss.hex()}", flush=True)
        if attempt == "0" and i + 1 == FLEET_LOW_HOLD:
            deadline = time.monotonic() + FLEET_HOLD_S
            while not resilience.preemption_requested():
                if time.monotonic() > deadline:
                    raise SystemExit(f"low: no preemption within "
                                     f"{FLEET_HOLD_S:g} s")
                time.sleep(0.05)
        if resilience.preemption_requested():
            # Read once: a SIGTERM between a test and the save's own
            # test would save a step this line does not name.
            print(f"FLEET_SAVE job=low step={i + 1}", flush=True)
            resilience.maybe_save_and_exit(ckpt, state(i + 1), i + 1)
    print(f"FLEET_OK job=low steps={FLEET_LOW_STEPS}", flush=True)


def _fleet_high() -> None:
    from horovod_tpu_torch.benchmark import run_lm_benchmark

    res = run_lm_benchmark(
        **LM, attention="flash", remat="none", momentum_dtype="bfloat16",
        num_warmup_batches=FLEET_LM_STEPS[0], num_batches_per_iter=1,
        num_iters=FLEET_LM_STEPS[1])
    losses = res["step_losses"]
    check(all(v == v and abs(v) != float("inf") for v in losses),
          f"high: LM losses {losses}")
    print("FLEET_OK job=high " + json.dumps(
        {"ms_per_step": res["ms_per_step"], "losses": losses,
         "tok_sec_per_chip": res["tok_sec_per_chip"]}), flush=True)


def _chaos_worker(ckpt: str, out: str) -> None:
    """Phase 21 (b)'s rank: CHAOS_STEPS allreduces on gloo, each step
    checkpointed; a relaunch resumes from the last one."""
    import os

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint

    torch.set_num_threads(1)
    hvd.init(device="cpu")
    attempt = os.environ.get("HOROVOD_RESTART_ATTEMPT", "0")
    state = {"w": torch.zeros(4), "step": torch.zeros((), dtype=torch.int64)}
    state = checkpoint.restore(ckpt, state)
    start = int(state["step"])
    if attempt == "1" and start != 3:
        raise SystemExit(f"attempt 1 resumed at step {start}, not 3")
    for step in range(start, CHAOS_STEPS):
        g = torch.full((4,), float(step + hvd.rank())) / 3
        state["w"] = state["w"] + hvd.allreduce(g, name=f"chaos.{step}")
        state["step"] = torch.tensor(step + 1)
        checkpoint.save(ckpt, state, step + 1)
    if hvd.rank() == 0:
        torch.save(state["w"], out)
        print(f"CHAOS_OK attempt={attempt} start={start}", flush=True)
    hvd.shutdown()


def _fleet_chaos_cpu():
    """Phase 21 (b): starts the faulted job and the clean one; returns the
    function that waits for both and checks them."""
    import os
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp()
    t0 = time.perf_counter()
    env = {"OMP_NUM_THREADS": "1", "HOROVOD_TERMINATE_GRACE_SECONDS": "3"}
    procs = {}
    for name, spec in (("fault", CHAOS_SPEC), ("clean", "")):
        procs[name] = _launcher(
            ["-np", "2", "--elastic-restarts", "1", sys.executable,
             os.path.abspath(__file__), "--chaos-worker",
             os.path.join(tmp, f"{name}_ckpt"),
             os.path.join(tmp, f"{name}.pt")],
            env=dict(env, HOROVOD_FAULT_SPEC=spec), wait=False)

    ended = {}

    def watch(name, proc):
        proc.wait()
        ended[name] = time.perf_counter()

    import threading
    watchers = [threading.Thread(target=watch, args=item, daemon=True)
                for item in procs.items()]
    for w in watchers:
        w.start()

    def finish() -> None:
        try:
            outs = {}
            for name, proc in procs.items():
                rc = proc.wait(timeout=300)
                proc.out.seek(0)
                proc.err.seek(0)
                outs[name] = (rc, proc.out.read(), proc.err.read())
                check(rc == 0, f"phase 21 (b): the {name} job exited {rc}:"
                      f"\n{outs[name][1][-3000:]}\n{outs[name][2][-3000:]}")
            for w in watchers:
                w.join(timeout=10)
            seconds = max(ended.values()) - t0
            got = torch.load(os.path.join(tmp, "fault.pt"))
            want = torch.load(os.path.join(tmp, "clean.pt"))
        finally:
            for proc in procs.values():
                proc.kill()
                proc.out.close()
                proc.err.close()
            shutil.rmtree(tmp, ignore_errors=True)
        _, out, err = outs["fault"]
        check("firing kind=crash" in out + err
              and "elastic restart 1/1" in err
              and "CHAOS_OK attempt=1 start=3" in out,
              f"phase 21 (b): no crash, restart and resume at step 3:\n"
              f"{out[-2000:]}\n{err[-2000:]}")
        check(torch.equal(got, want), f"phase 21 (b): resumed state "
              f"{got.tolist()} != uninterrupted {want.tolist()}")
        print(f"phase 21 (b): 2 gloo ranks under {CHAOS_SPEC!r} in "
              f"{seconds:.1f} s (beside (a)): rank 1 SIGKILLed at its 4th "
              f"allreduce, elastic restart 1/1 resumed at step 3 and "
              f"ended at the uninterrupted run's state bit for bit",
              flush=True)

    return finish


def _kernel_launches(path: str) -> dict:
    """``hvd_kernel_launches`` of a rank's metrics file, by kernel."""
    with open(path) as f:
        doc = json.load(f)
    fam = doc["metrics"].get("hvd_kernel_launches", {"values": []})
    return {v["labels"]["kernel"]: int(v["value"]) for v in fam["values"]}


def phase_fleet(smi: str, main: dict) -> tuple:
    """Phase 21; returns (the fused-stem launches of (a), the flash
    launches of (a) by counter name)."""
    import gc
    import glob
    import os
    import re
    import shlex
    import shutil
    import tempfile

    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.telemetry import aggregate

    finish_chaos = _fleet_chaos_cpu()
    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp()
    summary = os.path.join(tmp, "fleet.json")

    def job(name: str) -> str:
        stub = _FLEET_STUB.format(root=root, job=name, out=tmp)
        return f"{sys.executable} -c {shlex.quote(stub)}"

    t0 = time.perf_counter()
    try:
        p = _launcher(
            ["fleet", "-H", "localhost:1", "--starvation-deadline",
             str(FLEET_STARVATION), "--tick-interval", "0.25",
             "--metrics-file", summary, "--fleet-dir",
             os.path.join(tmp, "fleet"),
             "--job", f"low 0 1 -- {job('low')}",
             "--job", f"high 10 1 after={FLEET_HIGH_AFTER} -- "
                      f"{job('high')}"],
            env={"HOROVOD_TERMINATE_GRACE_SECONDS": "60"}, timeout=900)
        seconds = time.perf_counter() - t0
        log = f"{p.stdout[-4000:]}\n{p.stderr[-4000:]}"
        check(p.returncode == 0, f"phase 21 (a): the fleet exited "
              f"{p.returncode}:\n{log}")
        for line in ("admit job low np=1", "preempting job low", "starved",
                     "job low preempted (rc 75)", "admit job high np=1",
                     "job high finished ok", "(resume)",
                     "job low finished ok"):
            check(line in p.stderr, f"phase 21 (a): no {line!r}:\n{log}")
        check("blacklisting host" not in p.stderr,
              f"phase 21 (a): a host was blamed:\n{log}")
        devices = [json.loads(m) for m in re.findall(
            r"<stdout>:FLEET_DEVICE (\{.*\})$", p.stdout, re.M)]
        check(sorted((d["job"], d["attempt"]) for d in devices)
              == [("high", "0"), ("low", "0"), ("low", "1")]
              and all(d["platform"] == "gpu"
                      and d["device"] == torch.cuda.get_device_name(0)
                      and d["visible"] == "0" for d in devices),
              f"phase 21 (a): attempts and devices {devices}")
        saved = [int(v) for v in re.findall(r"FLEET_SAVE job=low step=(\d+)",
                                            p.stdout)]
        resumed = [int(v) for v in re.findall(
            r"FLEET_RESUME job=low start=(\d+)", p.stdout)]
        check(len(saved) == 1 and 1 <= saved[0] <= FLEET_LOW_HOLD
              and resumed == saved,
              f"phase 21 (a): saved at {saved}, resumed at {resumed}")
        losses = {int(i): float.fromhex(v) for i, v in re.findall(
            r"FLEET_LOSS step=(\d+) (\S+)$", p.stdout, re.M)}
        check(sorted(losses) == list(range(FLEET_LOW_STEPS)),
              f"phase 21 (a): low's steps {sorted(losses)}")
        timed = [losses[i] for i in range(WARMUP_STEPS, FLEET_LOW_STEPS)]
        check(timed == main["step_losses"],
              f"phase 21 (a): low's losses {timed} are not phase 4's "
              f"{main['step_losses']}")
        with open(summary) as f:
            doc = json.load(f)
        snap = doc["controller"]["metrics"]
        adm = aggregate.counter_total(snap, "hvd_fleet_admissions_total")
        pre = aggregate.counter_total(snap, "hvd_fleet_preemptions_total")
        check(doc["schema"] == "horovod_tpu.fleet.summary.v1"
              and adm == 3 and pre == 1
              and doc["jobs"]["low"]["preemptions"] == 1
              and doc["jobs"]["low"]["attempts"] == 2
              and doc["jobs"]["low"]["state"] == "done"
              and doc["jobs"]["high"]["state"] == "done",
              f"phase 21 (a): summary admissions {adm}, preemptions {pre}, "
              f"jobs {doc['jobs']}")
        runs = {os.path.basename(f)[:-5]: _kernel_launches(f) for f in
                glob.glob(os.path.join(tmp, "*.attempt*.json"))}
        check(sorted(runs) == ["high.attempt0", "low.attempt0",
                               "low.attempt1"],
              f"phase 21 (a): metrics files {sorted(runs)}")
        stem = [runs.get(f"low.attempt{a}", {}).get("fused_stem", 0)
                for a in (0, 1)]
        check(stem == [saved[0], FLEET_LOW_STEPS - saved[0]],
              f"phase 21 (a): fused_stem launches {stem} in low's metrics "
              f"files, expected [{saved[0]}, "
              f"{FLEET_LOW_STEPS - saved[0]}]")
        flash = {c.name: runs.get("high.attempt0", {}).get(c.name, 0)
                 for c in (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)}
        want = LM["n_layers"] * sum(FLEET_LM_STEPS)
        check(all(v == want for v in flash.values()),
              f"phase 21 (a): flash launches {flash} in high's metrics "
              f"file, expected {want} each")
        high = json.loads(re.search(r"FLEET_OK job=high (\{.*\})$",
                                    p.stdout, re.M).group(1))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 21 (a): fleet on {smi} in {seconds:.1f} s: low (ResNet-50 "
          f"s2d_fused, batch {BATCH}) preempted at step {saved[0]} (rc 75, "
          f"no host blamed) for high (LM of record, "
          f"{high['ms_per_step']:.1f} ms/step, not gated), resumed at step "
          f"{resumed[0]}; losses of steps {WARMUP_STEPS}-"
          f"{FLEET_LOW_STEPS - 1} bit for bit phase 4's; admissions "
          f"{int(adm)}, preemptions {int(pre)}; fused_stem launches "
          f"{stem}, flash {flash} (metrics files)", flush=True)
    finish_chaos()
    print(f"phase 21: {time.perf_counter() - t0:.1f} s", flush=True)
    return sum(stem), flash


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import horovod_tpu_torch as hvd

    smi = phase_card()
    phase_build()
    _lap("phases 1 and 2")
    stem_row = phase_kernel_check()
    _lap("phase 3")
    stem_row["launches"], _, main_summary = phase_main_path(smi)
    _lap("phase 4")
    phase_reference()
    _lap("phase 5")
    flash_rows = phase_flash_check()
    _lap("phase 6")
    counts, lm_summary = phase_lm_main_path(smi)
    _lap("phase 7")
    instance_counts = {}
    _add_counts(instance_counts, phase_lm_f32(smi, lm_summary))
    _lap("phase 7 (b)")
    _add_counts(instance_counts, phase_lm_wide(smi, lm_summary))
    _lap("phase 7 (c)")
    _add_counts(instance_counts, phase_lm_wide512(smi, lm_summary))
    _lap("phase 7 (d)")
    _add_counts(instance_counts, phase_lm_reference())
    _lap("phase 8")
    phase_hvd_api(smi, main_summary)
    _lap("phase 9")
    control = phase_control_plane(smi, main_summary)
    _lap("phase 10")
    ring = phase_sequence_parallel(smi)
    _lap("phase 11 (a)")
    lm_sp = phase_lm_parallel(smi, lm_summary)
    _lap("phase 11 (b)")
    phase_parallel_processes(smi)
    _lap("phase 11 (c)")
    decode = phase_decode(smi)
    _lap("phase 12 (a)")
    remat = phase_remat(smi, lm_summary)
    _lap("phase 12 (b)")
    phase_pipeline(smi)
    _lap("phase 12 (c)")
    phase_pipeline_processes(smi)
    _lap("phase 12 (d)")
    zero = phase_zero(smi, lm_summary)
    _lap("phase 13 (a)")
    phase_zero_processes(smi)
    _lap("phase 13 (b)")
    guard = phase_moe_and_resilience(smi, lm_summary)
    _lap("phase 14")
    phase_moe_processes(smi)
    _lap("phase 14 (e)")
    warm = phase_warm_restart(smi, lm_summary)
    _lap("phase 15")
    stem_row["launches"] += phase_control_instruments(smi, main_summary,
                                                      control)
    _lap("phase 16")
    tele_stem, tele_flash = phase_telemetry(smi, main_summary, control)
    _lap("phase 17")
    stem_row["launches"] += tele_stem
    stem_row["launches"] += phase_zoo_and_lanes(smi, main_summary)
    _lap("phase 18")
    phase_serving(smi)
    _lap("phase 19")
    stem_row["launches"] += phase_launcher(smi, main_summary)
    _lap("phase 20")
    fleet_stem, fleet_flash = phase_fleet(smi, main_summary)
    _lap("phase 21")
    stem_row["launches"] += fleet_stem
    check(decode[0] > 0, "phase 12 (a) did not launch the flash forward")
    for row, *count in zip(flash_rows, counts.values(), ring, lm_sp, remat,
                           zero, guard, warm, tele_flash,
                           fleet_flash.values()):
        check(all(count), f"{row['name']} did not launch on every path: "
              f"phase 7, 11 (a), 11 (b), 12 (b), 13 (a), 14 (b, c), 15, "
              f"17 (b), 21 (a) {count}")
        row["launches"] = sum(count)
    flash_rows[0]["launches"] += decode[0]
    # The other instances' rows: their launches on phases 7 (b), 7 (c),
    # 7 (d) and 8, the paths that run them.
    for row in flash_rows[3:]:
        kind, inst, d = row["instance"]
        row["launches"] = instance_counts.get((inst, d), {}).get(kind, 0)
        check(row["launches"] > 0, f"{row['name']} was launched on no path")
    for row in flash_rows:
        del row["instance"]
    hvd.shutdown()
    print(smi, flush=True)
    print(json.dumps({"kernels": [stem_row] + flash_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--preempt-worker"]:
        _preempt_worker(*sys.argv[2:4])
        sys.exit(0)
    if sys.argv[1:2] == ["--warm-worker"]:
        _warm_worker(*sys.argv[2:4])
        sys.exit(0)
    if sys.argv[1:2] == ["--disk-worker"]:
        _disk_rung_worker(*sys.argv[2:4])
        sys.exit(0)
    if sys.argv[1:2] == ["--control-worker"]:
        _control_worker(*sys.argv[2:])
        sys.exit(0)
    if sys.argv[1:2] == ["--inception-readings"]:
        inception_readings()
        sys.exit(0)
    if sys.argv[1:2] == ["--flash-f32-readings"]:
        flash_f32_readings()
        sys.exit(0)
    if sys.argv[1:2] == ["--ptxas"]:
        from horovod_tpu_torch.ops import _build
        for r in _build.ptxas_report():
            print(f"ptxas {r['source']}: {r['kernel']}: {r.get('registers')}"
                  f" registers, {r.get('stack')} bytes stack, "
                  f"{r.get('spill_stores')} / {r.get('spill_loads')} bytes "
                  f"spill stores / loads, {r['spill_ops_in_loops']} of "
                  f"{r['spill_ops']} spill instructions in a loop; warnings "
                  f"{r['warnings']}", flush=True)
        sys.exit(0)
    if sys.argv[1:2] == ["--avg-pool-check"]:
        avg_pool_check(gate=False)
        sys.exit(0)
    if sys.argv[1:2] == ["--hier-worker"]:
        _hier_worker(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--chaos-worker"]:
        _chaos_worker(*sys.argv[2:4])
        sys.exit(0)
    if sys.argv[1:2] == ["--telemetry-worker"]:
        _telemetry_worker(*sys.argv[2:4])
        sys.exit(0)
    sys.exit(main())
