"""The port's device profiling (``horovod_tpu_torch/utils/profiling.py``)
held against the reference's ``horovod_tpu/utils/profiling.py`` on the
CPU.

* On one trace-viewer document with a GPU track (gzipped, in a temp dir)
  the port's ``device_op_durations``, ``by_category`` and
  ``print_profile`` give what the reference's do.
* On a synthetic torch-format trace (two module scopes, a backward
  thread, a kernel launched outside any module and one whose launch is
  not in the trace) ``by_layer`` assigns every kernel once, to the scope
  of its launch or, in an autograd node, of the forward op with the
  node's sequence number.
* ``trace_once`` on the CPU writes a host-only trace that
  ``device_op_durations`` refuses, as the reference's does.
"""

import gzip
import json

import pytest
import torch

from horovod_tpu.utils import profiling as ref
from horovod_tpu_torch.utils import profiling

VIEWER_DOC = {"traceEvents": [
    {"ph": "M", "name": "process_name", "pid": 1,
     "args": {"name": "/host:CPU"}},
    {"ph": "M", "name": "process_name", "pid": 3,
     "args": {"name": "/device:GPU:1"}},
    {"ph": "M", "name": "process_name", "pid": 2,
     "args": {"name": "/device:GPU:0"}},
    {"ph": "X", "pid": 1, "name": "host_op", "ts": 0, "dur": 900},
    {"ph": "X", "pid": 2, "name": "jit_step", "ts": 0, "dur": 500},
    {"ph": "X", "pid": 2, "name": "while.3", "ts": 0, "dur": 400},
    {"ph": "X", "pid": 2, "name": "0", "ts": 0, "dur": 300},
    {"ph": "X", "pid": 2, "name": "fusion.1", "ts": 10, "dur": 120.5},
    {"ph": "X", "pid": 2, "name": "fusion.2", "ts": 140, "dur": 30.25},
    {"ph": "X", "pid": 2, "name": "fusion.1", "ts": 180, "dur": 20},
    {"ph": "X", "pid": 2, "name": "convolution.7", "ts": 210, "dur": 64},
    {"ph": "X", "pid": 2, "name": "all-reduce", "ts": 280, "dur": 8},
    {"ph": "X", "pid": 3, "name": "fusion.1", "ts": 10, "dur": 999},
]}


@pytest.fixture()
def viewer_trace(tmp_path):
    path = str(tmp_path / "t.trace.json.gz")
    with gzip.open(path, "wt") as f:
        json.dump(VIEWER_DOC, f)
    return path


def test_viewer_layout_matches_the_reference(viewer_trace, capsys):
    durs = profiling.device_op_durations(viewer_trace)
    assert durs == ref.device_op_durations(viewer_trace)
    assert profiling.by_category(durs) == ref.by_category(durs)
    for steps, top in ((1, 20), (4, 2)):
        ref.print_profile(viewer_trace, steps=steps, top=top)
        want = capsys.readouterr().out
        profiling.print_profile(viewer_trace, steps=steps, top=top)
        assert capsys.readouterr().out == want
    # A plain (not gzipped) file reads the same.
    plain = viewer_trace[:-3]
    with open(plain, "w") as f:
        json.dump(VIEWER_DOC, f)
    assert profiling.device_op_durations(plain) == durs


def test_zero_duration_trace_prints_like_the_reference(tmp_path, capsys):
    doc = {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/device:GPU:0"}},
        {"ph": "X", "pid": 1, "name": "fusion.1", "dur": 0}]}
    path = str(tmp_path / "z.json.gz")
    with gzip.open(path, "wt") as f:
        json.dump(doc, f)
    ref.print_profile(path)
    want = capsys.readouterr().out
    profiling.print_profile(path)
    assert capsys.readouterr().out == want
    assert "no timed device ops" in want


MAIN, BACKWARD = 100, 200


def _x(name, cat, ts, dur, tid, pid=7, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def _torch_doc():
    """Two Linear scopes inside a Net (forward ops with sequence numbers
    4 and 9), their two backward nodes on the backward thread, an SGD
    kernel launched outside any module and a kernel whose launch the
    trace lacks."""
    seq = "Sequence number"
    ev = [
        {"ph": "M", "name": "process_name", "pid": 7,
         "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
        _x("nn.Module: Net_0", "python_function", 0, 100, MAIN),
        _x("nn.Module: Linear_0", "python_function", 10, 30, MAIN),
        _x("aten::linear", "cpu_op", 11, 25, MAIN, **{seq: 3}),
        _x("aten::addmm", "cpu_op", 12, 20, MAIN, **{seq: 4}),
        _x("cudaLaunchKernel", "cuda_runtime", 15, 2, MAIN, correlation=1),
        _x("nn.Module: Linear_1", "python_function", 50, 30, MAIN),
        _x("aten::addmm", "cpu_op", 52, 20, MAIN, **{seq: 9}),
        _x("cudaLaunchKernel", "cuda_runtime", 55, 2, MAIN, correlation=2),
        _x("autograd::engine::evaluate_function: AddmmBackward0", "cpu_op",
           200, 40, BACKWARD, **{seq: 9}),
        _x("AddmmBackward0", "cpu_op", 201, 38, BACKWARD, **{seq: 9}),
        _x("cudaLaunchKernel", "cuda_runtime", 210, 2, BACKWARD,
           correlation=3),
        _x("cudaLaunchKernel", "cuda_runtime", 220, 2, BACKWARD,
           correlation=4),
        _x("autograd::engine::evaluate_function: AddmmBackward0", "cpu_op",
           250, 40, BACKWARD, **{seq: 4}),
        _x("cudaLaunchKernel", "cuda_runtime", 260, 2, BACKWARD,
           correlation=5),
        _x("cudaLaunchKernel", "cuda_runtime", 300, 2, MAIN, correlation=6),
    ]
    kernels = [("gemm_fwd0", 5.0, 1), ("gemm_fwd1", 7.0, 2),
               ("gemm_dx1", 11.0, 3), ("gemm_dw1", 13.0, 4),
               ("gemm_dw0", 17.0, 5), ("sgd_kernel", 19.0, 6),
               ("lost_kernel", 23.0, 99)]
    for i, (name, dur, corr) in enumerate(kernels):
        ev.append(_x(name, "kernel", 1000 + 50 * i, dur, 7, pid=0,
                     correlation=corr))
    # A second card's track is not read.
    ev.append(_x("gemm_fwd0", "kernel", 1000, 29.0, 7, pid=1,
                 correlation=1))
    return {"traceEvents": ev}


def test_by_layer_assigns_each_kernel_once():
    doc = _torch_doc()
    layers = dict(profiling.by_layer(doc))
    assert layers == {("Linear_0", "fwd"): 5.0, ("Linear_1", "fwd"): 7.0,
                      ("Linear_1", "bwd"): 24.0, ("Linear_0", "bwd"): 17.0,
                      ("other", "fwd"): 19.0, ("untracked", "?"): 23.0}
    durs = profiling.device_op_durations(doc)
    assert sum(layers.values()) == sum(us for us, _ in durs.values())
    assert durs["gemm_fwd0"] == (5.0, 1)
    # A pattern that matches no scope sends the tracked kernels to other.
    other = dict(profiling.by_layer(doc, pattern="^Conv_"))
    assert other == {("other", "fwd"): 31.0, ("other", "bwd"): 41.0,
                     ("untracked", "?"): 23.0}


def test_unlayered_shares_are_the_other_and_untracked_time():
    doc = _torch_doc()
    assert profiling.unlayered_shares(profiling.by_layer(doc)) == (
        19.0 / 95.0, 23.0 / 95.0)
    assert profiling.unlayered_shares(
        profiling.by_layer(doc, pattern="^Conv_")) == (72.0 / 95.0,
                                                      23.0 / 95.0)
    assert profiling.unlayered_shares([]) == (0.0, 0.0)


def test_kernel_categories_cover_the_ports_kernels():
    cats = {n: profiling.kernel_category(n) for n in (
        "fused_stem_kernel<128>", "flash_fwd_kernel<128>",
        "ncclDevKernel_AllReduce", "sm90_xmma_gemm_bf16",
        "void at::native::reduce_kernel<512>",
        "void at::native::vectorized_elementwise_kernel<4>",
        "Memcpy DtoD")}
    assert list(cats.values()) == ["fused_stem", "flash_attention",
                                   "collective", "conv_matmul", "reduction",
                                   "elementwise", "other"]
    durs = {"a.1": (2.0, 1), "a.2": (3.0, 1), "flash_fwd_kernel": (7.0, 2)}
    assert profiling.by_category(durs, profiling.kernel_category) == [
        ("flash_attention", 7.0), ("other", 5.0)]


def test_trace_once_on_the_cpu_has_no_device_track(tmp_path):
    def run():
        torch.ones(64, 64) @ torch.ones(64, 64)

    path = profiling.trace_once(run, str(tmp_path))
    assert path.startswith(str(tmp_path))
    with pytest.raises(RuntimeError, match="no device track"):
        profiling.device_op_durations(path)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        profiling.trace_steps(run, torch.device("cpu"), 1, 5)


def test_a_host_trace_with_stack_records_module_scopes(tmp_path):
    """The scopes by_layer reads are in torch's export when ``layers``
    is on (and only then), on the thread that ran the forward."""
    net = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.ReLU(),
                              torch.nn.Linear(8, 2))
    x = torch.randn(4, 8)

    def run():
        net(x).sum().backward()

    for layers in (False, True):
        doc = profiling._load(profiling.trace_once(run, str(tmp_path),
                                                   layers=layers))
        scopes = sorted(e["name"] for e in doc["traceEvents"]
                        if e.get("cat") == "python_function"
                        and e["name"].startswith("nn.Module: "))
        want = ["nn.Module: Linear_0", "nn.Module: Linear_1",
                "nn.Module: ReLU_0", "nn.Module: Sequential_0"]
        assert scopes == (want if layers else [])
