"""The port's ``hvd.*`` API on the card: every op at NCCL size 1 keeps
the device and dtype of its input and returns the size-1 result, the
control plane answers names submitted in reversed orders and ``join``,
``DistributedOptimizer`` trains a small ResNet on ``cuda:0`` exactly as
the optimizer it wraps, and two ranks on two cards pair names by name
and join with uneven batches, and across cards the parallel LM steps
(dp x tp x sp, dp x pp, ZeRO-1), the ragged MoE exchange, a ZeRO-1
state spilled at 2 ranks and warm-restored at 1 (ranks started by the
port's launcher), a synchronized-BN ResNet step and the eager plane's
two-level collectives at 2 x 2 (``-k hier``, with the hierarchical
lane's A/B) match gloo, and the scaling-efficiency lane runs.
Every test here carries the ``cuda`` marker and skips without a CUDA
device.  This file imports torch and the port only, so it runs on a GPU
host without JAX:

    python -m pytest --noconftest tests/test_torch_cuda_collective.py -m cuda
"""

import pytest
import torch

import horovod_tpu_torch as hvd


@pytest.fixture()
def nccl_world(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NCCL carries tensors on the card)")
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
                "HOROVOD_LOCAL_SIZE", "HOROVOD_COORDINATOR_ADDR"):
        monkeypatch.delenv(var, raising=False)
    hvd.shutdown()
    hvd.init()
    assert hvd.nccl_built() and not hvd.gloo_enabled()
    yield torch.device("cuda", 0)
    hvd.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int32, torch.int64])
def test_ops_keep_device_dtype_and_size1_result(nccl_world, dtype):
    dev = nccl_world
    ps = hvd.add_process_set([0])
    base = torch.arange(-6, 6, device=dev).reshape(3, 4).to(dtype)
    for x in (base, base[1, 2].clone(), base[:0]):
        ops = [hvd.allreduce(x), hvd.allreduce(x, op=hvd.Sum),
               hvd.allreduce(x, op=hvd.Min), hvd.allreduce(x, op=hvd.Max),
               hvd.allreduce(x, process_set=ps), hvd.allgather(x),
               hvd.broadcast(x, 0), hvd.grouped_allreduce([x, x])[0],
               hvd.synchronize(hvd.allreduce_async(x)),
               hvd.synchronize(hvd.allgather_async(x)),
               hvd.synchronize(hvd.broadcast_async(x, 0)),
               hvd.synchronize(hvd.grouped_allreduce_async([x]))[0]]
        if x.dim():
            ops += [hvd.reducescatter(x), hvd.alltoall(x),
                    hvd.alltoall(x, splits=[x.shape[0]])[0]]
        if dtype.is_floating_point:
            ops.append(hvd.allreduce(x, op=hvd.Adasum))
        for got in ops:
            assert got.device == dev and got.dtype == dtype
            assert got.shape == x.shape and torch.equal(got, x)
    y = base.clone()
    assert hvd.allreduce_(y, op=hvd.Sum) is y and torch.equal(y, base)
    if dtype.is_floating_point:
        got = hvd.allreduce(base, prescale_factor=0.5, postscale_factor=3.0)
        assert torch.equal(got, (base.double() * 1.5).to(dtype))


@pytest.mark.cuda
def test_objects_barrier_and_cpu_tensor_under_nccl(nccl_world):
    assert hvd.broadcast_object({"a": [1, 2]}) == {"a": [1, 2]}
    assert hvd.allgather_object(("x", 3)) == [("x", 3)]
    hvd.barrier()
    # A CPU tensor in an NCCL world rides the card and comes back.
    x = torch.arange(4.0)
    out = hvd.allreduce(x)
    assert out.device.type == "cpu" and torch.equal(out, x)


@pytest.mark.cuda
def test_runtime_answers_reversed_names_and_join_on_the_card(nccl_world):
    """Names submitted in an order reversed every other round, each op
    kind, through the runtime's thread, stream and NCCL group."""
    dev = nccl_world
    xs = [torch.arange(i + 3, device=dev, dtype=torch.float32) * (i + 1)
          for i in range(6)]
    for rnd in range(4):
        order = list(range(6))[::-1 if rnd % 2 else 1]
        hs = {i: hvd.allreduce_async(xs[i], name=f"rev.{i}", op=hvd.Sum)
              for i in order}
        gs = {i: hvd.allgather_async(xs[i], name=f"rev.g.{i}")
              for i in order}
        bs = {i: hvd.broadcast_async(xs[i], 0, name=f"rev.b.{i}")
              for i in order}
        for i in range(6):
            for h in (hs[i], gs[i], bs[i]):
                got = hvd.synchronize(h)
                assert got.device == dev and torch.equal(got, xs[i])
    rt = hvd.basics.runtime()
    assert rt.thread.is_alive() and rt.cycles > 0
    assert hvd.join() == 0
    assert torch.equal(hvd.allreduce(xs[0]), xs[0])


def _pair_worker(rank, size, addr, out_dir):
    import os
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=addr)
    hvd.init()
    try:
        dev = hvd.device()
        x = torch.full((4,), 1.0 + rank, device=dev)
        y = torch.full((4,), 10.0 * (rank + 1), device=dev)
        pairs = [("x", x), ("y", y)][::-1 if rank else 1]
        hs = {k: hvd.allreduce_async(v, name=k, op=hvd.Sum)
              for k, v in pairs}
        out = {"x": hvd.synchronize(hs["x"]), "y": hvd.synchronize(hs["y"])}
        # Rank r has r + 1 batches, then joins.
        out["batches"] = torch.stack([hvd.allreduce(
            torch.ones(3, device=dev), op=hvd.Sum, name=f"batch.{b}")
            for b in range(rank + 1)])
        out["last"] = hvd.join()
        out["after"] = hvd.allreduce(torch.ones(2, device=dev), op=hvd.Sum,
                                     name="after")
        both, second = hvd.add_process_set([0, 1]), hvd.add_process_set([1])
        out["set"] = hvd.allreduce(x, op=hvd.Sum, process_set=both)
        if rank == 1:  # hvdlint: allow(rank-divergent)
            out["set1"] = hvd.allreduce(x, op=hvd.Sum, process_set=second)
        torch.save({k: v.cpu() if torch.is_tensor(v) else v
                    for k, v in out.items()}, f"{out_dir}/pair{rank}.pt")
    finally:
        hvd.shutdown()


@pytest.mark.cuda
def test_two_rank_nccl_pairs_names_and_joins(tmp_path):
    """Two NCCL ranks on two cards: x and y issued in opposite orders
    reduce to 3 and 30 on both, a join with uneven batches sums only the
    active rank's data and reports rank 1 last, and process sets work."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import socket

    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    mp.start_processes(_pair_worker, args=(2, addr, str(tmp_path)),
                       nprocs=2, start_method="spawn")
    res = [torch.load(f"{tmp_path}/pair{r}.pt") for r in range(2)]
    for r, out in enumerate(res):
        assert torch.equal(out["x"], torch.full((4,), 3.0))
        assert torch.equal(out["y"], torch.full((4,), 30.0))
        want = torch.tensor([[2.0] * 3, [1.0] * 3][:r + 1])
        assert torch.equal(out["batches"], want)
        assert out["last"] == 1
        assert torch.equal(out["after"], torch.full((2,), 2.0))
        assert torch.equal(out["set"], torch.full((4,), 3.0))
    assert torch.equal(res[1]["set1"], torch.full((4,), 2.0))


@pytest.mark.cuda
def test_distributed_optimizer_trains_small_resnet_as_wrapped(nccl_world,
                                                             monkeypatch):
    """Two SGD steps of a small s2d_fused ResNet through
    DistributedOptimizer (after both state broadcasts) equal two steps of
    the plain optimizer on an identical model, with cuDNN held to
    deterministic algorithms."""
    from horovod_tpu_torch.models.resnet import BasicBlock, ResNet
    from horovod_tpu_torch.ops import fused_stem

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    g = torch.Generator(device="cpu").manual_seed(4)
    images = torch.randn(4, 8, 8, 12, generator=g).cuda()
    labels = torch.randint(0, 5, (4,), generator=g).cuda()
    states = []
    for wrap in (False, True):
        model = ResNet(stage_sizes=[1, 1], block_cls=BasicBlock,
                       num_classes=5, num_filters=16, stem="s2d_fused",
                       dtype=torch.float32,
                       generator=torch.Generator().manual_seed(0),
                       device="cuda")
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        if wrap:
            opt = hvd.DistributedOptimizer(
                opt, named_parameters=model.named_parameters())
            hvd.broadcast_parameters(model.state_dict(), root_rank=0)
            hvd.broadcast_optimizer_state(opt, root_rank=0)
        before = fused_stem.launches.count
        for _ in range(2):
            loss = torch.nn.functional.cross_entropy(model(images), labels)
            loss.backward()
            opt.step()
            opt.zero_grad()
        assert fused_stem.launches.count == before + 2
        states.append({k: v.detach().clone()
                       for k, v in model.state_dict().items()})
    for k, v in states[0].items():
        assert torch.equal(states[1][k], v), k


# ---------------------------------------------------------------------------
# Four ranks: NCCL on four cards against gloo on the CPU
# ---------------------------------------------------------------------------

class _TwoBranch(torch.nn.Module):
    """Even ranks build branch a first, odd ranks branch b, so backward
    produces their gradients in other orders; only rank 0's loss touches
    c, whose gradient the other ranks lack."""

    def __init__(self, rank):
        super().__init__()
        torch.manual_seed(1)
        self.rank = rank
        self.a = torch.nn.Linear(6, 5)
        self.b = torch.nn.Linear(6, 5)
        self.c = torch.nn.Linear(6, 1)

    def forward(self, x):
        first, second = ((self.a, self.b) if self.rank % 2 == 0
                         else (self.b, self.a))
        loss = (first(x) ** 2).mean() + (second(x).tanh() ** 2).mean()
        if self.rank == 0:
            loss = loss + (self.c(x) ** 2).mean()
        return loss


def _multi_rank_ops(rank: int, n: int) -> dict:
    """Every op on this rank's inputs; results on the CPU by name.  The
    inputs are small integers, so every sum is exact whatever its order."""
    dev = hvd.device()
    res = {}

    def put(key, t):
        res[key] = t.detach().cpu()

    g = torch.Generator().manual_seed(100 + rank)
    small = torch.randint(-8, 9, (8, 6), generator=g).float()
    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.int32,
                  torch.int64):
        x = small.to(dtype).to(dev)
        name = str(dtype).removeprefix("torch.")
        for op in ("Average", "Sum", "Min", "Max"):
            put(f"{op}_{name}", hvd.allreduce(x, op=getattr(hvd, op)))
        put(f"scaled_{name}", hvd.allreduce(x, prescale_factor=0.5,
                                            postscale_factor=3.0))
        put(f"grouped_{name}", torch.cat(hvd.grouped_allreduce(
            [x, x[:3] * 2], op=hvd.Sum)))
    print(f"rank {rank}: reductions done", flush=True)
    vec = torch.randn(257, generator=torch.Generator().manual_seed(7 + rank))
    put("adasum_4", hvd.allreduce(vec.to(dev), op=hvd.Adasum))
    put("adasum_4_bf16", hvd.allreduce(vec.to(dev, torch.bfloat16),
                                       op=hvd.Adasum))
    ps3 = hvd.add_process_set([0, 1, 2])
    ps13 = hvd.add_process_set([1, 3])
    # Only members submit on a process set.  Rank 2 folds into rank 0.
    if rank < 3:  # hvdlint: allow(rank-divergent)
        put("adasum_3", hvd.allreduce(vec.to(dev), op=hvd.Adasum,
                                      process_set=ps3))
    if rank in (1, 3):  # hvdlint: allow(rank-divergent)
        x = small.to(dev)
        put("set_sum", hvd.allreduce(x, op=hvd.Sum, process_set=ps13))
        put("set_broadcast", hvd.broadcast(x, 3, process_set=ps13))
        put("set_gather", hvd.allgather(x[:rank], process_set=ps13))
    print(f"rank {rank}: Adasum and process sets done", flush=True)
    put("gather_uneven", hvd.allgather(small[:rank + 1].to(dev)))
    put("gather_empty", hvd.allgather(small[:rank % 2].to(dev)))
    splits = [(rank + j) % 3 for j in range(n)]
    rows = sum(splits)
    out, recv = hvd.alltoall(
        (torch.arange(rows * 2.0).reshape(rows, 2) + 100 * rank).to(dev),
        splits=splits)
    put("alltoall_splits", out)
    put("alltoall_received", recv)
    put("alltoall_even", hvd.alltoall(small.to(dev)))
    put("reducescatter_sum", hvd.reducescatter(small.to(dev), op=hvd.Sum))
    put("reducescatter_average", hvd.reducescatter(small.to(dev)))
    put("broadcast", hvd.broadcast(small.to(dev), 2))
    y = small.to(dev).clone()
    h = hvd.allreduce_async_(y, op=hvd.Sum, name="y")
    hg = hvd.grouped_allreduce_async([small.to(dev), small[:1].to(dev)])
    put("async_inplace", hvd.synchronize(h))
    put("async_grouped", torch.cat(hvd.synchronize(hg)))
    res["objects"] = (hvd.broadcast_object({"rank": rank}, root_rank=3),
                      hvd.allgather_object(rank))
    hvd.barrier()
    print(f"rank {rank}: gathers, alltoall, handles done", flush=True)
    for case in ("plain", "fp16", "bpps2"):
        model = _TwoBranch(rank).to(dev)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters(),
            compression=(hvd.Compression.fp16 if case == "fp16"
                         else hvd.Compression.none),
            backward_passes_per_step=2 if case == "bpps2" else 1)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        for step in range(3):
            for k in range(2 if case == "bpps2" else 1):
                xb = torch.randn(
                    9, 6, generator=torch.Generator().manual_seed(
                        1000 * step + 10 * k + rank))
                model(xb.to(dev)).backward()
            opt.step()
            opt.zero_grad()
        put(f"optimizer_{case}", torch.cat(
            [p.detach().reshape(-1) for p in model.parameters()]))
    return res


def _multi_rank_worker(rank, size, addr, backend, out_dir):
    import os
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=addr,
                      HOROVOD_FUSION_THRESHOLD="64")
    hvd.init(device=None if backend == "nccl" else "cpu")
    try:
        assert hvd.device().type == ("cuda" if backend == "nccl" else "cpu")
        torch.save(_multi_rank_ops(rank, size),
                   f"{out_dir}/{backend}{rank}.pt")
    finally:
        hvd.shutdown()


def run_multi_rank(backend: str, size: int, out_dir: str) -> list:
    """``size`` ranks on ``backend``; returns each rank's results."""
    import socket

    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    mp.start_processes(_multi_rank_worker,
                       args=(size, addr, backend, out_dir), nprocs=size,
                       start_method="spawn")
    return [torch.load(f"{out_dir}/{backend}{r}.pt") for r in range(size)]


# Adasum's f64 dot products sum in another order on the card, and the
# optimizer's f32 gradient sums of four ranks in another ring order; every
# other result is exact (integer-valued inputs).
MULTI_RANK_RTOL = {"adasum_4": 1e-6, "adasum_3": 1e-6,
                   "adasum_4_bf16": 2 ** -7, "optimizer_plain": 1e-5,
                   "optimizer_fp16": 1e-3, "optimizer_bpps2": 1e-5}


@pytest.mark.cuda
def test_four_rank_nccl_matches_gloo(tmp_path):
    """Every op and three DistributedOptimizer variants on four NCCL ranks
    (one card each) against the same program on four gloo ranks on the
    CPU.  The optimizer's ranks differ in backward order and in which
    parameters have gradients, and the 64-byte fusion threshold makes
    many buckets, so the hooks' ordered launches from autograd's device
    threads are exercised."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    nccl = run_multi_rank("nccl", 4, str(tmp_path))
    gloo = run_multi_rank("gloo", 4, str(tmp_path))
    for r in range(4):
        assert nccl[r].keys() == gloo[r].keys()
        assert nccl[r].pop("objects") == gloo[r].pop("objects") == (
            {"rank": 3}, [0, 1, 2, 3])
        for key, want in gloo[r].items():
            got = nccl[r][key]
            assert got.dtype == want.dtype and got.shape == want.shape, key
            if key in MULTI_RANK_RTOL:
                tol = MULTI_RANK_RTOL[key]
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol, atol=tol, msg=key)
            else:
                assert torch.equal(got, want), (r, key)
    for key in ("adasum_4", "optimizer_plain", "optimizer_bpps2"):
        for r in range(1, 4):
            assert torch.equal(nccl[r][key], nccl[0][key]), (r, key)


@pytest.mark.cuda
def test_dp_tp_sp_lm_step_nccl_matches_gloo(tmp_path):
    """Two dp x tp x sp steps of a small bf16 LM (ring-flash attention,
    head_dim 64, T 512) on NCCL ranks, one card each: a 1x2x2 (data,
    model, seq) mesh on four cards, 1x1x2 on two or three, against the
    same program on gloo ranks on the CPU.  The losses and each leaf's
    update agree within ``chip_smoke.py``'s phase 11 (c) tolerances
    (bf16 compute rounds differently on the card)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    import chip_smoke
    shape = (1, 2, 2) if n >= 4 else (1, 1, 2)
    nccl = chip_smoke.run_parallel_lm_step("nccl", shape, str(tmp_path))
    gloo = chip_smoke.run_parallel_lm_step("gloo", shape, str(tmp_path))
    chip_smoke.compare_parallel_lm_step(nccl, gloo)


@pytest.mark.cuda
def test_dp_pp_lm_step_nccl_matches_gloo(tmp_path):
    """Two dp x pp steps of every schedule of a small bf16 pipelined LM (4
    layers, T 512, 2 microbatches; the interleaved schedules with 2 chunks
    a rank) on NCCL ranks, one card each: a 2x2 (data, pipe) mesh on four
    cards, 1x2 on two or three, against the same program on gloo ranks on
    the CPU.  The losses and each leaf's update agree within
    ``chip_smoke.py``'s phase 11 (c) tolerances, as phase 12 (d) holds
    them."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    import chip_smoke
    shape = (2, 2) if n >= 4 else (1, 2)
    nccl = chip_smoke.run_pipeline_lm_step("nccl", shape, str(tmp_path))
    gloo = chip_smoke.run_pipeline_lm_step("gloo", shape, str(tmp_path))
    chip_smoke.compare_pipeline_lm_step(nccl, gloo)


@pytest.mark.cuda
def test_zero_lm_step_and_two_level_collectives_nccl_match_gloo(tmp_path):
    """Two ZeRO-1 steps of a small bf16 LM (flash attention, head_dim 64,
    T 512) under the none and int8 codecs on NCCL ranks, one card each,
    against the same program on gloo ranks on the CPU, held within
    ``chip_smoke.py``'s phase 11 (c) tolerances; and on a 2x2 (dcn, ici)
    mesh (1x2 on two or three cards) the two-level reduce-scatter equal to
    the flat mean and ``cross_level_psum`` to the flat sum, on values
    where every sum is exact, NCCL equal to gloo (``-k zero``)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    import chip_smoke
    shape = (2, 2) if n >= 4 else (1, 2)
    nccl = chip_smoke.run_zero_step("nccl", shape, str(tmp_path))
    gloo = chip_smoke.run_zero_step("gloo", shape, str(tmp_path))
    print(chip_smoke.compare_zero_step(nccl, gloo))


@pytest.mark.cuda
def test_ragged_exchange_moe_and_shape_check_nccl_match_gloo(tmp_path):
    """``alltoall_ragged`` (payloads naming sender, destination and row;
    a capacity that drops rows; its gradient) bit for bit, an f32
    ``moe_layer_ragged`` at overflow and its gradients within
    ``chip_smoke.MOE_F32_TOL``, on NCCL ranks (one card each, up to 4)
    against gloo ranks on the CPU; and a reducescatter whose shape is bad
    on one rank fails every rank with the coordinator's words within 10 s
    (``-k ragged``)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    import chip_smoke
    size = min(n, 4)
    nccl = chip_smoke.run_moe_processes("nccl", size, str(tmp_path))
    gloo = chip_smoke.run_moe_processes("gloo", size, str(tmp_path))
    print(chip_smoke.compare_moe_processes(nccl, gloo))


def _warm_zero_job(backend, out_dir):
    """Two ZeRO-1 SGD steps on the launcher's ranks spilled every commit
    (a gathered full state on each rank), or, at size 1, that state warm
    restored into a fresh one-rank ZeRO-1 state, saved for comparison."""
    import os

    from horovod_tpu_torch import optim, resilience
    from horovod_tpu_torch.parallel import zero

    hvd.init(device=None if backend == "nccl" else "cpu")
    try:
        rank, size = hvd.rank(), hvd.size()
        dev = hvd.device()
        spill = os.path.join(out_dir, f"spill_{backend}")
        params = [torch.zeros(6, device=dev), torch.zeros(3, device=dev)]
        zopt = zero.sharded_optimizer(optim.sgd(0.5, 0.5))
        state = zopt.init(params)
        if size > 1:
            guard = resilience.StepGuard(policy="rollback", spill_dir=spill)
            for step in range(2):
                grads = [torch.full(p.shape, 0.25 * (rank + 1) * (step + 1),
                                    device=dev) for p in params]
                upd, state = zopt.update(grads, state, params)
                for p, u in zip(params, upd):
                    p.add_(u)
                guard.spill_extra["cursor"] = step
                guard.after_step(params, state, step, 0.5)
            return
        params, state, step, source, extra = resilience.warm_restore(
            params, state, directory=spill)
        full = zero.gather_full_state(state)
        torch.save({"step": step, "source": source, "extra": extra,
                    "params": [p.cpu() for p in params],
                    "trace": [t.cpu() for t in full.trace]},
                   f"{out_dir}/warm_{backend}.pt")
    finally:
        hvd.shutdown()


def _launch(np_: int, call: str, env=None, timeout: float = 300) -> str:
    """``call`` (an expression on this module, ``t``) in each of ``np_``
    ranks under the port's launcher (``python -m
    horovod_tpu_torch.runner``); returns the job's output."""
    import os
    import signal
    import subprocess
    import sys

    tests = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(tests)
    full = dict(os.environ, PYTHONPATH=os.pathsep.join([repo, tests]))
    full.update(env or {})
    code = f"import test_torch_cuda_collective as t; {call}"
    p = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", str(np_),
         sys.executable, "-c", code], cwd=repo, env=full,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        # The launcher's SIGINT tears its ranks down; keep what they said.
        p.send_signal(signal.SIGINT)
        out, err = p.communicate(timeout=60)
        raise AssertionError(f"the job outlived {timeout} s:\n"
                             f"{(out + err)[-6000:]}") from None
    assert p.returncode == 0, (out + err)[-6000:]
    return out


def _run_warm_zero(backend: str, size: int, out_dir: str) -> None:
    _launch(size, f"t._warm_zero_job({backend!r}, {out_dir!r})",
            env={"OMP_NUM_THREADS": "1"} if backend == "gloo" else None)


@pytest.mark.cuda
def test_warm_restore_of_a_two_rank_zero_state_nccl_matches_gloo(tmp_path):
    """Two NCCL ranks (one card each, started by the port's launcher)
    spill their ZeRO-1 state at every commit, in the full layout; one
    rank warm-restores it into a one-rank ZeRO-1 state (``source ==
    "spill"``, the spilled cursor), and the restored parameters and
    momentum are bit for bit what the same program on gloo ranks on the
    CPU restores (``-k warm``)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    out = {}
    for backend in ("nccl", "gloo"):
        _run_warm_zero(backend, 2, str(tmp_path))
        _run_warm_zero(backend, 1, str(tmp_path))
        out[backend] = torch.load(f"{tmp_path}/warm_{backend}.pt")
    for res in out.values():
        assert (res["step"], res["source"], res["extra"]) == (
            1, "spill", {"cursor": 1})
    for key in ("params", "trace"):
        for a, b in zip(out["nccl"][key], out["gloo"][key]):
            assert torch.equal(a, b), key


def _tree_worker(rank, size, addr, backend, mode, out_dir):
    import os
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_LOCAL_RANK=str(rank % 2),
                      HOROVOD_LOCAL_SIZE="2", HOROVOD_COORDINATOR_ADDR=addr,
                      HOROVOD_FUSION_THRESHOLD="64",
                      HOROVOD_TOPOLOGY="hostA:2,hostB:2",
                      HOROVOD_COORD_TREE="1" if mode == "tree" else "0")
    hvd.init(device=f"cuda:{rank}" if backend == "nccl" else "cpu")
    try:
        res = _multi_rank_ops(rank, size)
        res["tree"] = hvd.basics.runtime().coord_tree_enabled()
        res["cache_hits"] = hvd.basics.runtime().cache_hits
        torch.save(res, f"{out_dir}/{mode}_{backend}{rank}.pt")
    finally:
        hvd.shutdown()


def run_tree(backend: str, mode: str, out_dir: str) -> list:
    """Four ranks on ``backend`` as two faked hosts of two, coordinated
    through the tree (``mode="tree"``) or flat; each rank's results."""
    import socket

    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    mp.start_processes(_tree_worker, args=(4, addr, backend, mode, out_dir),
                       nprocs=4, start_method="spawn")
    return [torch.load(f"{out_dir}/{mode}_{backend}{r}.pt")
            for r in range(4)]


@pytest.mark.cuda
def test_tree_coordination_over_nccl_equals_flat_bit_for_bit(tmp_path):
    """``HOROVOD_COORD_TREE=1`` under a faked 2 hosts x 2
    ``HOROVOD_TOPOLOGY``, one card a rank: every rank coordinates through
    the tree (members -> host leader -> rank 0) and every result of
    :func:`_multi_rank_ops` is bit for bit the flat job's on the same
    cards (``-k tree``)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    tree = run_tree("nccl", "tree", str(tmp_path))
    flat = run_tree("nccl", "flat", str(tmp_path))
    for r in range(4):
        assert tree[r].pop("tree") and not flat[r].pop("tree"), r
        tree[r].pop("cache_hits")
        flat[r].pop("cache_hits")
        assert tree[r].keys() == flat[r].keys()
        assert tree[r].pop("objects") == flat[r].pop("objects")
        for key, want in flat[r].items():
            assert torch.equal(tree[r][key], want), (r, key)


@pytest.mark.cuda
def test_scaling_efficiency_over_nccl(tmp_path):
    """``run_scaling_efficiency`` for ResNet-50 ``s2d_fused`` at
    ``chip_smoke.py``'s batch on one NCCL rank a card (up to 4; one host,
    so the baseline is rank 0 alone): the reference's keys, the same dict
    on every rank, ``0 < efficiency <= 1.5`` (``-k scaling``)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    import chip_smoke
    print(chip_smoke.run_scaling_processes(min(n, 4), str(tmp_path)))


@pytest.mark.cuda
def test_sync_bn_step_nccl_matches_gloo(tmp_path):
    """Two steps of a small ResNet whose BatchNorms average over every
    rank, on NCCL ranks (one card each, up to 4) against gloo ranks on the
    CPU, within ``chip_smoke.py``'s phase 5 limits, each backend's state
    one value on every rank (``-k sync_bn``)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    import chip_smoke
    size = min(n, 4)
    nccl = chip_smoke.run_sync_bn_step("nccl", size, str(tmp_path))
    gloo = chip_smoke.run_sync_bn_step("gloo", size, str(tmp_path))
    print(chip_smoke.compare_sync_bn_step(nccl, gloo))


HIER_SIZES = (1, 7, 100_003, 1_000_003)


def _hier_job(backend: str, out_dir: str) -> None:
    """One rank of a 4-rank job split into 2 hosts of 2 (``HOROVOD_LOCAL_*``
    set before ``init``; on the card each rank keeps the card of its
    launched local rank): the eager allreduce (Sum, Average) and allgather
    (uneven first dimensions) at odd sizes in f32, bf16 and int32 on
    integer-valued data, flat, then, after a re-init at a fresh
    rendezvous, through the two-level plane at threshold 0."""
    import os

    import numpy as np

    rank = int(os.environ["HOROVOD_RANK"])
    card = int(os.environ["HOROVOD_LOCAL_RANK"])
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
        hvd.init(device=f"cuda:{card}" if backend == "nccl" else "cpu")
        rt = hvd.basics.runtime()
        dev = hvd.device()
        out[f"{mode}/enabled"] = (rt.hierarchical_enabled(),
                                  rt.hierarchical_allgather_enabled())
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            for n in HIER_SIZES:
                g = np.random.default_rng(1000 * rank + n)
                x = torch.from_numpy(g.integers(-8, 8, n).astype(
                    np.float32)).to(dtype).to(dev)
                for op in (hvd.Sum, hvd.Average):
                    out[f"{mode}/ar/{dtype}/{n}/{op}"] = hvd.allreduce(
                        x, op=op, name=f"ar.{dtype}.{n}.{op}").cpu()
                y = x[:max(n - 3 * rank, 1)]
                out[f"{mode}/ag/{dtype}/{n}"] = hvd.allgather(
                    y, name=f"ag.{dtype}.{n}").cpu()
        out[f"{mode}/counters"] = dict(rt.hier_counters)
    hvd.shutdown()
    torch.save(out, f"{out_dir}/hier_{backend}{rank}.pt")


def run_hier(backend: str, out_dir: str) -> list:
    """:func:`_hier_job` on 4 ranks of ``backend``; each rank's results."""
    _launch(4, f"t._hier_job({backend!r}, {out_dir!r})",
            env={"OMP_NUM_THREADS": "1"} if backend == "gloo" else None)
    return [torch.load(f"{out_dir}/hier_{backend}{r}.pt")
            for r in range(4)]


@pytest.mark.cuda
def test_hierarchical_eager_collectives_over_nccl_match_gloo(tmp_path):
    """The eager plane's two-level allreduce and allgather at 2 x 2 over
    NCCL, one card a rank (``-k hier``): enabled on every rank, each
    result bit for bit the flat plane's on the same cards and the gloo
    job's on the CPU, the cross bytes summed over the ranks half the flat
    bytes; then ``run_hierarchical_benchmark``'s A/B on the cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    from horovod_tpu_torch.benchmark import run_hierarchical_benchmark

    nccl = run_hier("nccl", str(tmp_path))
    gloo = run_hier("gloo", str(tmp_path))
    for run in (nccl, gloo):
        flat = sum(res["flat/counters"]["flat_allreduce_bytes"]
                   for res in run)
        cross = sum(res["hier/counters"]["hier_cross_bytes"] for res in run)
        assert flat > 0 and 2 * cross == flat, (flat, cross)
    for r in range(4):
        for res in (nccl[r], gloo[r]):
            assert res.pop("flat/enabled") == (False, False)
            assert res.pop("hier/enabled") == (True, True)
            del res["flat/counters"], res["hier/counters"]
        for key, want in nccl[r].items():
            if key.startswith("hier/"):
                assert torch.equal(want, nccl[r]["flat/" + key[5:]]), key
            assert torch.equal(want, gloo[r][key]), (r, key)
    res = run_hierarchical_benchmark(verbose=True)
    assert res["cross_bytes_ratio"] == [0.5, 0.5], res
