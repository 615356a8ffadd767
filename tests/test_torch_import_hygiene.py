"""The port stands alone: it imports torch and never JAX or the JAX
package, and its entry points never fall back to the CPU on their own."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch import basics, benchmark
from horovod_tpu_torch.models import resnet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_import_leaves_jax_and_reference_out_of_sys_modules():
    code = ("import sys, horovod_tpu_torch, horovod_tpu_torch.benchmark\n"
            "import horovod_tpu_torch.ops.compression, "
            "horovod_tpu_torch.parallel.zero, "
            "horovod_tpu_torch.parallel.hierarchical, "
            "horovod_tpu_torch.models.convert, "
            "horovod_tpu_torch.parallel.expert, "
            "horovod_tpu_torch.checkpoint, horovod_tpu_torch.resilience, "
            "horovod_tpu_torch.faults, horovod_tpu_torch.ops._threefry, "
            "horovod_tpu_torch.tree, horovod_tpu_torch.runner.rpc, "
            "horovod_tpu_torch.native.runtime, "
            "horovod_tpu_torch.native.timeline, "
            "horovod_tpu_torch.native.autotune, "
            "horovod_tpu_torch.native.coord_tree, "
            "horovod_tpu_torch.telemetry, "
            "horovod_tpu_torch.telemetry.registry, "
            "horovod_tpu_torch.telemetry.exporter, "
            "horovod_tpu_torch.telemetry.spans, "
            "horovod_tpu_torch.telemetry.eager_timeline, "
            "horovod_tpu_torch.telemetry.aggregate, "
            "horovod_tpu_torch.telemetry.trace_merge, "
            "horovod_tpu_torch.telemetry.critical_path, "
            "horovod_tpu_torch.serving, horovod_tpu_torch.serving.model, "
            "horovod_tpu_torch.serving.replica, "
            "horovod_tpu_torch.serving.router, "
            "horovod_tpu_torch.utils.logging, "
            "horovod_tpu_torch.utils.profiling, "
            "horovod_tpu_torch.coordination, "
            "horovod_tpu_torch.runner, horovod_tpu_torch.runner.run, "
            "horovod_tpu_torch.runner.launch, "
            "horovod_tpu_torch.runner.hosts, "
            "horovod_tpu_torch.runner.config_parser, "
            "horovod_tpu_torch.runner.network, "
            "horovod_tpu_torch.runner.fleet\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


def _sources():
    root = os.path.join(REPO, "horovod_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "inception_cudnn_study.py")


def test_no_source_imports_jax_or_the_reference_package():
    offenders = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, REPO)}:{node.lineno} "
                          f"{n}" for n in names if _forbidden(n)]
    assert offenders == []


@pytest.fixture()
def no_gpu(monkeypatch):
    """A machine without a CUDA device, and no world initialized."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    thvd.shutdown()
    assert not thvd.is_initialized()
    yield
    thvd.shutdown()


def test_make_bench_state_without_gpu_or_device_raises(no_gpu):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        benchmark.make_bench_state("resnet18", batch_size=1, image_size=32)
    assert not thvd.is_initialized()


def test_entry_points_without_gpu_raise(no_gpu):
    with pytest.raises(RuntimeError, match="CUDA"):
        thvd.init()
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark.run_synthetic_benchmark("resnet18", batch_size=1,
                                          image_size=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        resnet.ResNet18(num_classes=2)
    assert basics.resolve_device("cpu") == torch.device("cpu")


def test_benchmark_runs_on_cpu_only_when_asked(no_gpu):
    """device='cpu' is the caller asking: a tiny run completes, reports
    the CPU as its device and no device metric."""
    res = benchmark.run_synthetic_benchmark(
        "resnet18", batch_size=2, image_size=32, num_classes=4,
        num_warmup_batches=1, num_batches_per_iter=1, num_iters=2,
        stem="s2d_fused", device="cpu", verbose=False)
    assert res["platform"] == "cpu" and res["device"] == "cpu"
    assert res["mfu"] is None and res["max_memory_allocated"] is None
    assert len(res["step_losses"]) == 2
    assert all(l == l for l in res["step_losses"])


def test_a_rank_without_a_card_fails_its_job(tmp_path):
    """The launcher's job fails with a non-zero rc when a rank finds no
    card and was not asked for the CPU (here: the CUDA runtime hidden),
    instead of running on the CPU."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "1",
         sys.executable, "-m", "horovod_tpu_torch.benchmark",
         "--model", "resnet18", "--batch-size", "1", "--image-size", "32",
         "--num-iters", "1"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert p.returncode != 0, p.stdout + p.stderr
    assert "device='cpu'" in p.stdout + p.stderr
    assert "RESULT" not in p.stdout


def test_the_fleet_subcommand_is_refused_not_run(tmp_path):
    """``python -m horovod_tpu_torch.runner fleet`` is the port's fleet
    controller: it starts where ``import jax`` and ``import horovod_tpu``
    fail, takes the reference's flags, and runs a job to its end.  (The
    name is kept from when the subcommand was refused.)"""
    stub = tmp_path / "stub"
    for pkg in ("jax", "horovod_tpu"):
        (stub / pkg).mkdir(parents=True)
        (stub / pkg / "__init__.py").write_text(
            f"raise ImportError('{pkg} is not installed on this host')\n")
    env = dict(os.environ, PYTHONPATH=f"{stub}{os.pathsep}{REPO}")
    env.pop("HOROVOD_FAULT_SPEC", None)
    probe = subprocess.run([sys.executable, "-c", "import jax"], env=env,
                           capture_output=True, text=True, timeout=60)
    assert probe.returncode != 0 and "not installed" in probe.stderr
    p = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "fleet",
         "--help"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=60)
    assert p.returncode == 0, p.stderr
    from horovod_tpu.runner import fleet as ref_fleet
    for action in ref_fleet.build_parser()._actions:
        for flag in action.option_strings:
            assert flag in p.stdout, flag
    marker = tmp_path / "ran"
    p = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "fleet",
         "-H", "localhost:1", "--tick-interval", "0.05", "--job",
         f"only 0 1 -- {sys.executable} -c "
         f"\"import sys; assert 'jax' not in sys.modules; "
         f"open({str(marker)!r}, 'w')\""],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "admit job only np=1" in p.stderr and marker.exists()
