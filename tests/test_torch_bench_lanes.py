"""The port's benchmark lanes: the new models through
``run_synthetic_benchmark``, ``run_scaling_efficiency`` in a 3-rank gloo
job (its baseline is one rank a host: rank 0 here), and
``run_step_guard_benchmark``'s dict and ``BENCH`` line, each against the
JAX package's keys (the reference's lanes driven with a stubbed
throughput run, so no JAX model is compiled).
"""

import json
import os

import numpy as np
import pytest

import horovod_tpu.benchmark as jbench
import horovod_tpu_torch.benchmark as tbench
from torch_support import start_port_job, world1  # noqa: F401

TINY = dict(num_classes=4, num_warmup_batches=1, num_batches_per_iter=1,
            num_iters=2, device="cpu", verbose=False)


@pytest.mark.parametrize("name,size", [("vgg11", 32), ("inception3", 75)])
def test_new_models_run_through_the_synthetic_benchmark(world1, name,  # noqa: F811
                                                        size):
    res = tbench.run_synthetic_benchmark(name, 2, image_size=size, **TINY)
    assert len(res["step_losses"]) == 2
    assert all(np.isfinite(res["step_losses"]))
    assert res["stem"] == "conv7" and res["platform"] == "cpu"
    fwd = jbench._FWD_GFLOPS_224[name]
    assert tbench._FWD_GFLOPS_224[name] == fwd
    assert res["flops_per_step"] == pytest.approx(
        3.0 * fwd * 1e9 * (size / 224.0) ** 2 * 2)


def test_flop_table_is_the_references():
    assert tbench._FWD_GFLOPS_224 == jbench._FWD_GFLOPS_224


JOB = r'''
import os, sys
import numpy as np
import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics, benchmark

out = sys.argv[1]
hvd.init(device="cpu")
topo = basics.topology()
# Every rank its own host: no rank is left beyond the baseline.
real = basics.topology
basics.topology = lambda: topo._replace(leaders=(0, 1, 2))
try:
    benchmark.run_scaling_efficiency("resnet18", 2)
    words = ""
except ValueError as e:
    words = str(e)
basics.topology = real
res = benchmark.run_scaling_efficiency(
    "resnet18", batch_size=2, image_size=32, num_classes=4,
    num_warmup_batches=1, num_batches_per_iter=1, num_iters=2,
    device="cpu", verbose=False)
# The same lane on stubbed throughput runs: the baseline run, then the
# 3-rank one (only rank 0's numbers are broadcast).
rates = iter(STUB_RATES)
real_run = benchmark.run_synthetic_benchmark
benchmark.run_synthetic_benchmark = (
    lambda *a, **k: {"img_sec_total": next(rates)})
stub = benchmark.run_scaling_efficiency("resnet18", 2, verbose=False)
benchmark.run_synthetic_benchmark = real_run
np.savez(os.path.join(out, f"rank{hvd.rank()}.npz"), words=words,
         keys=np.array(sorted(res)),
         **{k: np.asarray(v) for k, v in res.items() if k != "model"},
         **{"stub_" + k: np.asarray(v) for k, v in stub.items()
            if k != "model"})
hvd.shutdown()
'''
STUB_RATES = (100.0, 240.0)


def test_scaling_efficiency_on_three_gloo_ranks(tmp_path):
    """The lane's protocol on 3 gloo ranks: its words, devices and keys,
    rank 0's rates on every rank, and its efficiency equal to the
    reference's on the same stubbed rates.  The real run's rates are
    wall-clock throughputs on a shared CPU, so its efficiency is held to
    its formula, not to a range."""
    finish = start_port_job(f"STUB_RATES = {STUB_RATES!r}\n" + JOB,
                            str(tmp_path), np_=3,
                            env={"OMP_NUM_THREADS": "1"}, timeout=180)
    ranks, _ = finish()
    want = _reference_scaling(STUB_RATES, n_devices=3)
    for got in ranks:
        assert str(got["words"]) == (
            "scaling efficiency needs more total devices (3) than "
            "baseline devices (3; one per process)")
        assert int(got["n_devices"]) == 3
        assert int(got["n_baseline_devices"]) == 1
        assert float(got["img_sec_1"]) > 0 and float(got["img_sec_n"]) > 0
        assert float(got["scaling_efficiency"]) == (
            float(got["img_sec_n"]) / (3 * float(got["img_sec_1"])))
        for k in ("img_sec_1", "img_sec_n", "scaling_efficiency"):
            assert float(got[k]) == float(ranks[0][k])
        for k, v in want.items():
            if k != "model":
                assert float(got["stub_" + k]) == v, k
    assert want["scaling_efficiency"] == 0.8
    assert list(ranks[0]["keys"]) == sorted(want)


def _stub_runs(monkeypatch, module, rates):
    """``module.run_synthetic_benchmark`` returning ``rates`` in turn,
    with the step-guard policy it saw."""
    seen = []

    def fake(model_name, batch_size, **kwargs):
        seen.append(os.environ.get("HOROVOD_STEP_GUARD"))
        return {"img_sec_total": rates[len(seen) - 1]}

    monkeypatch.setattr(module, "run_synthetic_benchmark", fake)
    return seen


def _reference_scaling(rates, n_devices):
    """The reference's dict, its throughput runs stubbed with ``rates``
    (baseline, then ``n_devices``)."""
    import horovod_tpu as jhvd
    mp = pytest.MonkeyPatch()
    try:
        _stub_runs(mp, jbench, list(rates))
        found = jhvd.is_initialized()
        if not found:
            jhvd.init()
        res = jbench.run_scaling_efficiency("resnet18", 2,
                                            n_devices=n_devices,
                                            verbose=False)
        if not found:
            jhvd.shutdown()
    finally:
        mp.undo()
    return res


def test_size1_scaling_efficiency_raises_the_references_words(world1):  # noqa: F811
    with pytest.raises(ValueError,
                       match=r"^scaling efficiency needs >= 2 devices, "
                             r"have 1$"):
        tbench.run_scaling_efficiency("resnet18", 2, **TINY)


@pytest.mark.parametrize("prev", [None, "rollback"])
def test_step_guard_lane_matches_the_references(monkeypatch, capsys, prev):
    """Both lanes on stubbed runs: the same dict and BENCH line, the
    baseline unset and the guarded run under ``skip``, and the policy put
    back as it was."""
    out = {}
    for name, module in (("ref", jbench), ("port", tbench)):
        if prev is None:
            monkeypatch.delenv("HOROVOD_STEP_GUARD", raising=False)
        else:
            monkeypatch.setenv("HOROVOD_STEP_GUARD", prev)
        seen = _stub_runs(monkeypatch, module, [200.0, 196.5])
        res = module.run_step_guard_benchmark("resnet50", 64)
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("BENCH ")]
        assert len(lines) == 1 and json.loads(lines[0][6:]) == res
        assert seen == [None, "skip"]
        assert os.environ.get("HOROVOD_STEP_GUARD") == prev
        out[name] = res
    assert out["port"] == out["ref"]
    assert out["port"]["value"] == pytest.approx(1.75)


def test_step_guard_lane_runs_the_port(world1, capsys):  # noqa: F811
    res = tbench.run_step_guard_benchmark("resnet18", 2, image_size=32,
                                          **TINY)
    assert res["metric"] == "step_guard_overhead_pct"
    assert res["baseline_img_sec"] > 0 and res["guarded_img_sec"] > 0
    assert "BENCH " in capsys.readouterr().out


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _flags(parser):
    return {opt: (a.dest, a.default) for a in parser._actions
            for opt in a.option_strings}


def test_the_cli_takes_the_reference_harnesss_flags(monkeypatch):
    """``python -m horovod_tpu_torch.benchmark`` parses the reference's
    ``_main`` flags with their defaults (its parser caught as it parses),
    less ``--transport`` and ``--coordsim``, which argparse refuses; the
    port adds ``--device``, ``--input-dtype`` and the LM profile's
    ``--lm-dtype``, and its ``--model`` also names the LM's and decode's
    profiles."""
    import argparse

    def capture(self, *args, **kwargs):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as caught:
        jbench._main()
    monkeypatch.undo()
    want, got = _flags(caught.value.parser), _flags(tbench.build_parser())
    assert set(want) - set(got) == {"--transport", "--coordsim"}
    assert set(got) - set(want) == {"--device", "--input-dtype",
                                    "--lm-dtype"}
    for opt in set(got) & set(want):
        assert got[opt] == want[opt], opt
    for refused in ("--transport", "--coordsim"):
        with pytest.raises(SystemExit) as e:
            tbench.build_parser().parse_args([refused])
        assert e.value.code == 2


def test_the_hierarchical_lane_on_four_gloo_ranks(capsys):
    """``run_hierarchical_benchmark(device="cpu")``: two ``-np 4`` runs of
    the port's launcher, flat and two-level, each size's latency side by
    side and the cross bytes half the flat bytes; the reference's keys."""
    res = tbench.run_hierarchical_benchmark(device="cpu", verbose=False)
    assert res["metric"] == "hierarchical_allreduce_latency"
    assert (res["np"], res["local_size"]) == (4, 2)
    assert [s["size"] for s in res["sizes"]] == [1 << 16, 1 << 20]
    assert res["cross_bytes_ratio"] == [0.5, 0.5]
    for s in res["sizes"]:
        assert s["flat_bytes"] == 4 * 8 * 4 * s["size"]
        assert s["flat_sec_per_op"] > 0 and s["hier_sec_per_op"] > 0
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("BENCH ")]
    assert json.loads(line[-1][len("BENCH "):]) == res
