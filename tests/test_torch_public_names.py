"""The port's last public names against the JAX package's, on the CPU.

* ``parallel.data.distributed_gradients``: the port's transform in one
  2-rank gloo job (one intra-op thread a rank) against the reference's
  optax transform under ``shard_map`` on 2 CPU devices, on the same
  per-rank trees of gradients (values on a 2^-3 grid, so the sums are
  exact on both sides);
* ``config.describe`` (and ``python -m horovod_tpu_torch.config``): the
  rows of the names both registries hold;
* ``runner.rpc.find_free_port``;
* ``models.transformer.init_abstract``: the meta tree against
  ``jax.eval_shape`` of the reference, through ``models/convert.py``'s
  names;
* ``models.transformer.stacked_layer_specs``.
"""

import inspect
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu import config as jconfig
from horovod_tpu.models import transformer as jtfm
from horovod_tpu.parallel import data as jdata
from horovod_tpu.runner import rpc as jrpc
from horovod_tpu_torch import config as tconfig
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.runner import rpc as trpc
from torch_support import REPO, start_port_job

# Each rank's tree of gradients (numpy), built the same way in the job
# and here: dicts (in the reference's order, sorted by key), a list and a
# tuple, on a 2^-3 grid.
TREES = r'''
def grad_tree(rank):
    rng = np.random.default_rng(40 + rank)

    def leaf(*shape):
        return np.round(rng.standard_normal(shape) * 8).astype(
            np.float32) / 8

    return {"w": leaf(3, 4), "b": [leaf(4), (leaf(2, 2), leaf(1))],
            "a": {"z": leaf(5), "y": leaf(2, 3)}}
'''
exec(TREES)

JOB = r'''
import sys

import numpy as np
import torch

torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops.collective import Sum
from horovod_tpu_torch.parallel.data import distributed_gradients
from horovod_tpu_torch.tree import tree_leaves
''' + TREES + r'''
hvd.init(device="cpu")
tree = grad_tree(hvd.rank())
grads = {"w": torch.from_numpy(tree["w"]),
         "b": [torch.from_numpy(tree["b"][0]),
               tuple(torch.from_numpy(x) for x in tree["b"][1])],
         "a": {k: torch.from_numpy(v) for k, v in tree["a"].items()}}
out = {}
for name, tx in (("average", distributed_gradients()),
                 ("sum", distributed_gradients(op=Sum))):
    state = tx.init(grads)
    reduced, state = tx.update(grads, state)
    assert state == () and isinstance(reduced["b"], list)
    assert isinstance(reduced["b"][1], tuple)
    assert list(reduced["a"]) == ["y", "z"]
    for i, x in enumerate(tree_leaves(reduced)):
        out[f"{name}/{i}"] = x.numpy()
np.savez(f"{sys.argv[1]}/rank{hvd.rank()}.npz", **out)
hvd.shutdown()
'''


def _reference_reduced(op):
    """The reference transform on 2 devices: each device's reduced leaves
    in its tree order."""
    trees = [grad_tree(r) for r in range(2)]
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)
    tx = jdata.distributed_gradients(op=op)

    def body(tree):
        tree = jax.tree_util.tree_map(lambda x: x[0], tree)
        reduced, state = tx.update(tree, tx.init(tree))
        return jax.tree_util.tree_map(lambda x: x[None], reduced)

    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    f = jax.shard_map(body, mesh=mesh, in_specs=P("data"),
                      out_specs=P("data"), check_vma=False)
    leaves = jax.tree_util.tree_leaves(f(stacked))
    return [[np.asarray(x)[r] for x in leaves] for r in range(2)]


def test_distributed_gradients_matches_reference(tmp_path):
    from horovod_tpu.ops import collective as jc

    finish = start_port_job(JOB, str(tmp_path), 2,
                            env={"OMP_NUM_THREADS": "1"})
    want = {"average": _reference_reduced(jc.Average),
            "sum": _reference_reduced(jc.Sum)}
    got, _ = finish()
    for name, per_rank in want.items():
        for r in range(2):
            assert len(per_rank[r]) == 6
            for i, leaf in enumerate(per_rank[r]):
                np.testing.assert_array_equal(got[r][f"{name}/{i}"], leaf,
                                              err_msg=f"{name} leaf {i}")


def _rows(mod):
    """``{name: (type, scope, default, doc)}`` of ``mod.describe()``, cut
    at the fixed widths of its registry."""
    reg = mod.REGISTRY.values()
    w0 = max(len(e.name) for e in reg)
    w3 = max(len("" if e.default is None else repr(e.default)) for e in reg)
    out = {}
    for row in mod.describe().splitlines():
        out[row[:w0].rstrip()] = (row[w0 + 2:w0 + 7].rstrip(),
                                  row[w0 + 8:w0 + 14].rstrip(),
                                  row[w0 + 15:w0 + 15 + w3].rstrip(),
                                  row[w0 + 17 + w3:])
    return out


# Defaults the two registries document differently: the reference's table
# says 30.0, its launcher applies 10.0 (horovod_tpu/runner/launch.py:31),
# as the port's does and documents; the port registers an unset fault
# spec as "" where the reference says None (both read as no spec).
DEFAULT_DIFFERS = {"HOROVOD_TERMINATE_GRACE_SECONDS": ("30.0", "10.0"),
                   "HOROVOD_FAULT_SPEC": ("", "''")}


def test_describe_rows_match_reference():
    """Every port variable has the reference's row: its name, type and
    default (one row a variable, sorted by name); the scope is ``py`` on
    every port row, and the docs are the port's own."""
    ref, port = _rows(jconfig), _rows(tconfig)
    assert list(port) == sorted(tconfig.REGISTRY)
    assert set(port) <= set(ref)
    for name, (type_, scope, default, doc) in port.items():
        r_type, _, r_default, _ = ref[name]
        assert type_ == r_type, name
        assert scope == "py" and doc == tconfig.REGISTRY[name].doc, name
        assert (r_default, default) == DEFAULT_DIFFERS.get(
            name, (r_default, r_default)), name


def test_config_main_prints_describe():
    out = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.config"],
                         capture_output=True, text=True, check=True,
                         cwd=REPO, timeout=120).stdout
    assert out.rstrip("\n") == tconfig.describe()


@pytest.mark.parametrize("bind", ["", "127.0.0.1"])
def test_find_free_port_matches_reference(bind):
    assert inspect.signature(trpc.find_free_port) == inspect.signature(
        jrpc.find_free_port)
    for fn in (trpc.find_free_port, jrpc.find_free_port):
        port = fn(bind)
        assert 0 < port < 65536
        with socket.socket() as s:
            s.bind((bind, port))


def _named(tree):
    """A parameter tree's leaves by ``models/convert.py``'s names."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{leaf}": v for leaf, v in layer.items()})
    return out


def test_init_abstract_matches_reference_eval_shape():
    kw = dict(vocab_size=96, d_model=64, n_heads=4, n_layers=3, d_ff=160,
              max_seq=48)
    abstract = jtfm.init_abstract(jtfm.TransformerConfig(**kw))
    got = _named(tfm.init_abstract(tfm.TransformerConfig(**kw)))
    names = convert.lm_params_to_torch(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), abstract))
    want = _named(abstract)
    assert sorted(got) == sorted(names) == sorted(want)
    for name, t in got.items():
        assert t.device.type == "meta", name
        assert tuple(t.shape) == tuple(names[name].shape) == \
            want[name].shape, name
        assert t.dtype == torch.float32 and want[name].dtype == jnp.float32


def test_stacked_layer_specs_match_reference():
    """The stage dim over the pipe axis, in param_specs' per-dim form:
    the reference's PartitionSpec as a tuple."""
    for axis in ("pipe", "stages"):
        assert tfm.stacked_layer_specs(axis) == tuple(
            jtfm.stacked_layer_specs(axis)) == (axis,)
    cfg = tfm.TransformerConfig(vocab_size=16, d_model=8, n_heads=2,
                                n_layers=4, d_ff=16, max_seq=8)
    stacked = tfm.stack_layer_params(tfm.init_abstract(cfg), 2)
    spec = tfm.stacked_layer_specs("pipe")
    for leaf in stacked.values():
        assert leaf.shape[0] == 2 and len(spec) <= leaf.dim()
