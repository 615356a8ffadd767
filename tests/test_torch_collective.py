"""The port's ``hvd.*`` collectives against the JAX package's, on the CPU.

* Ops with an SPMD counterpart are held against ``shard_map`` on a
  2-device submesh of the 8-device CPU mesh (``tests/conftest.py``).  The
  port's side runs in the job below on the process set ``[0, 1]``, whose
  two members take the two devices' inputs.  A sum of two values has one
  order, so these agree bitwise.
* Eager-only semantics (Adasum at 3 ranks, uneven allgather and alltoall,
  process sets, the ``*_object`` ops, Average on integers and 16-bit
  floats, the async handles) are held against the reference's own eager
  plane: one ``python -m horovod_tpu.runner -np 3`` job in which every
  rank runs the reference's op (its native runtime) and the port's (gloo,
  rendezvous through ``MASTER_ADDR``/``MASTER_PORT``) on the same inputs
  and writes both to an ``.npz``.  The inputs are small integers, so every
  sum is exact and the results agree bitwise, except Adasum, whose f64
  dot products sum in another order (tolerance per dtype below).
* Size-1 semantics and the error contracts run in this process on a gloo
  world of one, which every test shuts down again.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.ops import collective as jc
import horovod_tpu_torch as thvd
from horovod_tpu_torch.ops import collective as tc

from torch_support import jax_world, run_job, world1  # noqa: F401

JOB = r'''
import pickle
import sys

import ml_dtypes
import numpy as np
import torch

import horovod_tpu as jhvd
import horovod_tpu.torch as jt
import horovod_tpu_torch as thvd

out_dir = sys.argv[1]
jhvd.init()
thvd.init(device="cpu")
r, n = thvd.rank(), thvd.size()
assert (jhvd.rank(), jhvd.size(), n) == (r, n, 3)
BF16 = ml_dtypes.bfloat16
out = {}


def np_of(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy() if a.dtype == torch.bfloat16 \
            else a.detach().numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == BF16 else a


def put(key, ref, port, like=None):
    out["ref/" + key] = np_of(ref)
    out["port/" + key] = np_of(port)
    if like is not None:
        out["dtype/" + key] = np.array(str(port.dtype) == str(like.dtype)
                                       and port.device == like.device)


def t(a, dtype=None):
    x = torch.from_numpy(np.asarray(a, np.float32) if dtype else a)
    return x.to(dtype) if dtype else x


rng = np.random.default_rng(10 + r)
small = rng.integers(-8, 9, (4, 6)).astype(np.float32)

# --- Adasum at 3 ranks: rank 2 folds into rank 0 --------------------------
vecs = [np.random.default_rng(7 + i).standard_normal(129).astype(np.float32)
        for i in range(3)]
a = vecs[r]
put("adasum_f32", jhvd.allreduce(a, op=jhvd.Adasum, name="ad32"),
    thvd.allreduce(t(a), op=thvd.Adasum), t(a))
a64 = a.astype(np.float64)
put("adasum_f64", jt.allreduce(t(a64), op=jt.Adasum, name="ad64"),
    thvd.allreduce(t(a64), op=thvd.Adasum), t(a64))
a16 = a.astype(np.float16)
put("adasum_f16", jhvd.allreduce(a16, op=jhvd.Adasum, name="ad16"),
    thvd.allreduce(t(a16), op=thvd.Adasum), t(a16))
put("adasum_bf16", jhvd.allreduce(a.astype(BF16), op=jhvd.Adasum,
                                  name="adbf"),
    thvd.allreduce(t(a, torch.bfloat16), op=thvd.Adasum),
    t(a, torch.bfloat16))
z = a if r != 1 else np.zeros_like(a)
put("adasum_zero_norm", jhvd.allreduce(z, op=jhvd.Adasum, name="adz"),
    thvd.allreduce(t(z), op=thvd.Adasum))

# --- Average, Min, Max, scale factors ------------------------------------
vi = (np.array([-7, -1, 0, 5, 8, 11], np.int32) * (r + 1) - r)
put("average_i32", jt.allreduce(t(vi), name="avi32"),
    thvd.allreduce(t(vi)), t(vi))
vl = vi.astype(np.int64) * 1000003
put("average_i64", jt.allreduce(t(vl), name="avi64"),
    thvd.allreduce(t(vl)), t(vl))
# numpy computes bf16 with a Python scalar in float32, so the reference
# returns float32 here; the port returns bf16, the reference's value
# rounded once, as the torch binding would cast it back.
put("average_bf16", np.asarray(jhvd.allreduce(
        small.astype(BF16), name="avbf")).astype(BF16),
    thvd.allreduce(t(small, torch.bfloat16)), t(small, torch.bfloat16))
put("average_bf16_scaled",
    np.asarray(jhvd.allreduce(small.astype(BF16), prescale_factor=2.0,
                              postscale_factor=0.1,
                              name="avbfs")).astype(BF16),
    thvd.allreduce(t(small, torch.bfloat16), prescale_factor=2.0,
                   postscale_factor=0.1), t(small, torch.bfloat16))
put("average_f16_scaled",
    jhvd.allreduce(small.astype(np.float16), prescale_factor=2.0,
                   postscale_factor=0.1, name="av16s"),
    thvd.allreduce(t(small.astype(np.float16)), prescale_factor=2.0,
                   postscale_factor=0.1), t(small.astype(np.float16)))
put("average_f32_scaled",
    jhvd.allreduce(small, prescale_factor=0.5, postscale_factor=3.0,
                   name="av32s"),
    thvd.allreduce(t(small), prescale_factor=0.5, postscale_factor=3.0))
put("min_f32", jhvd.allreduce(small, op=jhvd.Min, name="min"),
    thvd.allreduce(t(small), op=thvd.Min))
put("max_i32", jt.allreduce(t(vi), op=jt.Max, name="maxi"),
    thvd.allreduce(t(vi), op=thvd.Max), t(vi))
put("sum_i64", jt.allreduce(t(vl), op=jt.Sum, name="sumi"),
    thvd.allreduce(t(vl), op=thvd.Sum), t(vl))

# --- gathers, broadcasts, alltoall, reducescatter ------------------------
g = np.full((r + 1, 2), r, np.float32) + np.arange(2, dtype=np.float32)
put("allgather_uneven_f32", jhvd.allgather(g, name="ag1"),
    thvd.allgather(t(g)), t(g))
gi = (np.arange((r + 1) * 3).reshape(r + 1, 3) + 10 * r).astype(np.int64)
put("allgather_uneven_i64", jhvd.allgather(gi, name="ag2"),
    thvd.allgather(t(gi)), t(gi))
ge = np.full((0 if r == 0 else 2, 3), r, np.float32)
put("allgather_empty_shard", jhvd.allgather(ge, name="ag3"),
    thvd.allgather(t(ge)))
splits = np.array([(r + j) % 3 for j in range(3)], np.int64)
x = (np.arange(splits.sum() * 2).reshape(-1, 2) + 100 * r).astype(
    np.float32)
ro, rrecv = jhvd.alltoall(x, splits=splits, name="a2av")
po, precv = thvd.alltoall(t(x), splits=t(splits))
put("alltoall_splits", ro, po, t(x))
put("alltoall_received", rrecv, precv)
xe = small[:3] + 100 * r
put("alltoall_even", jhvd.alltoall(xe, name="a2a"), thvd.alltoall(t(xe)))
put("broadcast_root2", jhvd.broadcast(small, root_rank=2, name="bc"),
    thvd.broadcast(t(small), root_rank=2), t(small))
s0 = np.array(1000 * r + 7, np.int64)
put("broadcast_scalar_i64", jt.broadcast(t(s0), 1, name="bc0"),
    thvd.broadcast(t(s0), root_rank=1), t(s0))
rs = rng.integers(-8, 9, (6, 2)).astype(np.float32)
put("reducescatter_sum", jhvd.reducescatter(rs, op=jhvd.Sum, name="rs1"),
    thvd.reducescatter(t(rs), op=thvd.Sum))
put("reducescatter_average", jhvd.reducescatter(rs, name="rs2"),
    thvd.reducescatter(t(rs)))
ref = jhvd.grouped_allreduce([small, small[:2] * 2], op=jhvd.Sum,
                             name="grp")
port = thvd.grouped_allreduce([t(small), t(small[:2] * 2)], op=thvd.Sum)
for i in range(2):
    put(f"grouped_sum_{i}", ref[i], port[i])

# --- async handles ----------------------------------------------------------
ref_h = [jhvd.allreduce_async(small, name="h1"),
         jhvd.allgather_async(g, name="h2"),
         jhvd.broadcast_async_(small, root_rank=1, name="h3")]
buf = t(small.copy())
port_h = [thvd.allreduce_async(t(small), name="h1"),
          thvd.allgather_async(t(g), name="h2"),
          thvd.broadcast_async_(buf, root_rank=1, name="h3"),
          thvd.grouped_allreduce_async([t(small), t(small[:2] * 2)],
                                       op=thvd.Sum, name="h4")]
out["port/async_poll_types"] = np.array(
    [isinstance(thvd.poll(h), bool) for h in port_h])
for key, rh, ph in zip(("async_allreduce", "async_allgather",
                        "async_broadcast_"), ref_h, port_h):
    put(key, jhvd.synchronize(rh), thvd.synchronize(ph))
out["port/async_broadcast_inplace"] = np_of(buf)
grouped = thvd.synchronize(port_h[3])
for i in range(2):
    put(f"async_grouped_{i}", ref[i], grouped[i])

# --- objects ---------------------------------------------------------------
obj = {"rank": r, "items": list(range(r + 1)), "name": f"r{r}"}
out["ref/broadcast_object"] = np.array(repr(
    jhvd.broadcast_object(obj, root_rank=1, name="bo")))
out["port/broadcast_object"] = np.array(repr(
    thvd.broadcast_object(obj, root_rank=1)))
out["ref/allgather_object"] = np.array(repr(
    jhvd.allgather_object(obj, name="ago")))
out["port/allgather_object"] = np.array(repr(thvd.allgather_object(obj)))

# --- process sets: every rank registers, members use them ----------------
jps = jhvd.add_process_set([0, 2])
tps = thvd.add_process_set([0, 2])
if r != 1:
    put("set_allreduce", jhvd.allreduce(small, op=jhvd.Sum, process_set=jps,
                                        name="ps1"),
        thvd.allreduce(t(small), op=thvd.Sum, process_set=tps))
    put("set_broadcast_root2",
        jhvd.broadcast(small, root_rank=2, process_set=jps, name="ps2"),
        thvd.broadcast(t(small), root_rank=2, process_set=tps))
    put("set_allgather", jhvd.allgather(g, process_set=jps, name="ps3"),
        thvd.allgather(t(g), process_set=tps))
else:
    msgs = []
    for op in (lambda: jhvd.allreduce(small, process_set=jps, name="bad"),
               lambda: thvd.allreduce(t(small), process_set=tps)):
        try:
            op()
            msgs.append("no error")
        except RuntimeError as e:
            msgs.append(str(e))
    out["ref/set_nonmember_error"] = np.array(msgs[0])
    out["port/set_nonmember_error"] = np.array(msgs[1])

# --- the SPMD counterparts, on the process set [0, 1] ---------------------
ps01 = thvd.add_process_set([0, 1])
if r < 2:
    srng = np.random.default_rng(200 + r)
    sx = srng.standard_normal((4, 3)).astype(np.float32)
    sy = srng.standard_normal((2, 5)).astype(np.float32)
    out["spmd_in/x"], out["spmd_in/y"] = sx, sy
    for op in ("Average", "Sum", "Min", "Max"):
        for pre, post in ((1.0, 1.0), (0.5, 3.0)):
            out[f"spmd/allreduce_{op}_{pre}_{post}"] = np_of(thvd.allreduce(
                t(sx), op=getattr(thvd, op), prescale_factor=pre,
                postscale_factor=post, process_set=ps01))
    out["spmd/adasum"] = np_of(thvd.allreduce(t(sx), op=thvd.Adasum,
                                              process_set=ps01))
    gx, gy = thvd.grouped_allreduce([t(sx), t(sy)], process_set=ps01)
    out["spmd/grouped_x"], out["spmd/grouped_y"] = np_of(gx), np_of(gy)
    out["spmd/allgather"] = np_of(thvd.allgather(t(sx), process_set=ps01))
    out["spmd/broadcast"] = np_of(thvd.broadcast(t(sx), root_rank=1,
                                                 process_set=ps01))
    out["spmd/reducescatter_sum"] = np_of(thvd.reducescatter(
        t(sx), op=thvd.Sum, process_set=ps01))
    out["spmd/reducescatter_average"] = np_of(thvd.reducescatter(
        t(sx), op=thvd.Average, process_set=ps01))
    out["spmd/alltoall"] = np_of(thvd.alltoall(t(sx), process_set=ps01))

thvd.barrier()
jhvd.barrier()
np.savez(f"{out_dir}/rank{r}.npz", **out)
thvd.shutdown()
jhvd.shutdown()
print(f"rank {r}: collective job done", flush=True)
'''


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    return run_job(JOB, str(tmp_path_factory.mktemp("collective_job")))


# ---------------------------------------------------------------------------
# SPMD counterparts: shard_map on 2 devices
# ---------------------------------------------------------------------------

def _spmd(fn, per_rank):
    """``fn`` under shard_map on a 2-device mesh; ``per_rank`` holds each
    device's input, the result each device's output."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    f = jax.shard_map(fn, mesh=mesh, in_specs=P("data"),
                      out_specs=P("data"), check_vma=False)
    out = np.asarray(f(jnp.concatenate([jnp.asarray(a) for a in per_rank])))
    return np.split(out, 2)


def _spmd_inputs(job, key="x"):
    return [job[r][f"spmd_in/{key}"] for r in range(2)]


@pytest.mark.parametrize("scale", [(1.0, 1.0), (0.5, 3.0)])
@pytest.mark.parametrize("op", ["Average", "Sum", "Min", "Max"])
def test_spmd_allreduce_matches_shard_map(job, op, scale):
    pre, post = scale
    want = _spmd(lambda x: jc.allreduce(
        x, op=getattr(jc, op), prescale_factor=pre, postscale_factor=post,
        axis_name="data"), _spmd_inputs(job))
    for r in range(2):
        np.testing.assert_array_equal(
            job[r][f"spmd/allreduce_{op}_{pre}_{post}"], want[r])


def _adasum_pair(a, b):
    """The reference's pair combine (data_plane.cc AdasumCombine)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    dot, na, nb = a @ b, a @ a, b @ b
    ac = 1.0 - dot / (2.0 * na) if na > 0 else 1.0
    bc = 1.0 - dot / (2.0 * nb) if nb > 0 else 1.0
    return ac * a + bc * b


def test_spmd_adasum_two_ranks_matches_reference_formula(job):
    """The JAX SPMD plane has no Adasum; at 2 ranks it is one pair
    combine of the reference's formula.  Tolerance 2e-7: the f64 dot
    products sum in another order before the one rounding to f32."""
    x0, x1 = _spmd_inputs(job)
    want = _adasum_pair(x0.ravel(), x1.ravel()).astype(np.float32)
    for r in range(2):
        np.testing.assert_allclose(job[r]["spmd/adasum"].ravel(), want,
                                   rtol=2e-7, atol=2e-7)
    np.testing.assert_array_equal(job[0]["spmd/adasum"],
                                  job[1]["spmd/adasum"])


@pytest.mark.parametrize("case", ["grouped", "allgather", "broadcast",
                                  "reducescatter_sum",
                                  "reducescatter_average", "alltoall"])
def test_spmd_ops_match_shard_map(job, case):
    xs = _spmd_inputs(job)
    if case == "grouped":
        # Each member's [x, y] against grouped_allreduce (fused_psum) on
        # the same two leaves.
        ys = _spmd_inputs(job, "y")
        wx = _spmd(lambda x: jc.grouped_allreduce([x], axis_name="data")[0],
                   xs)
        wy = _spmd(lambda y: jc.grouped_allreduce([y], axis_name="data")[0],
                   ys)
        for r in range(2):
            np.testing.assert_array_equal(job[r]["spmd/grouped_x"], wx[r])
            np.testing.assert_array_equal(job[r]["spmd/grouped_y"], wy[r])
        return
    fn = {
        "allgather": lambda x: jc.allgather(x, axis_name="data"),
        "broadcast": lambda x: jc.broadcast(x, root_rank=1,
                                            axis_name="data"),
        "reducescatter_sum": lambda x: jc.reducescatter(
            x, op=jc.Sum, axis_name="data"),
        "reducescatter_average": lambda x: jc.reducescatter(
            x, op=jc.Average, axis_name="data"),
        "alltoall": lambda x: jc.alltoall(x, axis_name="data"),
    }[case]
    want = _spmd(fn, xs)
    for r in range(2):
        np.testing.assert_array_equal(job[r][f"spmd/{case}"], want[r])


# ---------------------------------------------------------------------------
# Eager semantics: the reference's eager plane at 3 ranks
# ---------------------------------------------------------------------------

# Tolerance (rtol) per case; every other case is bitwise.  Adasum's f64
# dot products sum in another order than the native loop, so its result
# may differ by an ulp of its dtype per combine (two combines at 3 ranks).
ADASUM_RTOL = {"adasum_f32": 1e-6, "adasum_f64": 1e-12,
               "adasum_f16": 2 ** -10, "adasum_bf16": 2 ** -7,
               "adasum_zero_norm": 1e-6}

EAGER_CASES = [
    "adasum_f32", "adasum_f64", "adasum_f16", "adasum_bf16",
    "adasum_zero_norm", "average_i32", "average_i64", "average_bf16",
    "average_bf16_scaled", "average_f16_scaled", "average_f32_scaled",
    "min_f32", "max_i32", "sum_i64", "allgather_uneven_f32",
    "allgather_uneven_i64", "allgather_empty_shard", "alltoall_splits",
    "alltoall_received", "alltoall_even", "broadcast_root2",
    "broadcast_scalar_i64", "reducescatter_sum", "reducescatter_average",
    "grouped_sum_0", "grouped_sum_1", "async_allreduce", "async_allgather",
    "async_broadcast_", "async_grouped_0", "set_allreduce",
    "set_broadcast_root2", "set_allgather",
]


@pytest.mark.parametrize("case", EAGER_CASES)
def test_eager_matches_reference(job, case):
    ranks = [r for r in range(3) if f"port/{case}" in job[r]]
    assert ranks == ([0, 2] if case.startswith("set_") else [0, 1, 2])
    for r in ranks:
        got, want = job[r][f"port/{case}"], job[r][f"ref/{case}"]
        assert got.shape == want.shape, (r, got.shape, want.shape)
        if case in ADASUM_RTOL:
            np.testing.assert_allclose(got, want.astype(got.dtype),
                                       rtol=ADASUM_RTOL[case],
                                       atol=ADASUM_RTOL[case])
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
        if f"dtype/{case}" in job[r]:
            assert job[r][f"dtype/{case}"], "dtype or device changed"


def test_adasum_ranks_agree_bitwise(job):
    """Both members of a pair evaluate one expression on the same
    operands, so every rank holds the same bits."""
    for case in ("adasum_f32", "adasum_f64", "adasum_f16", "adasum_bf16"):
        for r in (1, 2):
            np.testing.assert_array_equal(job[r][f"port/{case}"],
                                          job[0][f"port/{case}"])


def test_async_broadcast_inplace_and_poll(job):
    for r in range(3):
        np.testing.assert_array_equal(job[r]["port/async_broadcast_inplace"],
                                      job[r]["ref/async_broadcast_"])
        assert job[r]["port/async_poll_types"].all()


@pytest.mark.parametrize("case", ["broadcast_object", "allgather_object",
                                  "set_nonmember_error"])
def test_objects_and_membership_errors_match_reference(job, case):
    for r in range(3):
        if f"port/{case}" in job[r]:
            assert str(job[r][f"port/{case}"]) == str(job[r][f"ref/{case}"])
    assert "is not a member" in str(job[1].get(
        "port/set_nonmember_error", "is not a member"))


# ---------------------------------------------------------------------------
# A world of one, in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int32, torch.int64])
def test_size1_ops_keep_dtype_device_and_values(jax_world, dtype):
    """Every op at size 1 returns its input's values (Adasum and Average
    are the identity, Min and Max too), dtype and device, including a
    0-dim and an empty tensor; pre/postscale multiply as the reference's
    size-1 eager plane does (bitwise)."""
    hvd = jax_world
    base = torch.arange(-3, 3).reshape(2, 3).to(dtype)
    for x in (base, base[0, 0].clone(), base[:0]):
        ops = [thvd.allreduce(x), thvd.allreduce(x, op=thvd.Sum),
               thvd.allreduce(x, op=thvd.Min), thvd.allreduce(x, op=thvd.Max),
               thvd.allreduce(x, process_set=thvd.add_process_set([0])),
               thvd.broadcast(x, 0), thvd.allgather(x),
               thvd.synchronize(thvd.allreduce_async(x)),
               thvd.synchronize(thvd.allgather_async(x)),
               thvd.synchronize(thvd.broadcast_async(x, 0)),
               thvd.grouped_allreduce([x, x])[1]]
        if x.dim():
            ops += [thvd.reducescatter(x), thvd.alltoall(x)]
        if dtype.is_floating_point:
            ops.append(thvd.allreduce(x, op=thvd.Adasum))
        for got in ops:
            assert got.dtype == dtype and got.device == x.device
            assert got.shape == x.shape and torch.equal(got, x)
    if dtype.is_floating_point:
        got = thvd.allreduce(base, prescale_factor=0.5,
                             postscale_factor=3.0)
        want = hvd.allreduce(jnp.asarray(base.float().numpy()).astype(
            str(dtype).removeprefix("torch.")), prescale_factor=0.5,
            postscale_factor=3.0)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want).astype(np.float32))


def test_size1_inplace_ops_write_into_the_tensor(world1):
    x = torch.arange(6.0)
    assert world1.allreduce_(x, op=world1.Sum) is x
    h = world1.allreduce_async_(x, postscale_factor=2.0)
    assert world1.synchronize(h) is x
    assert torch.equal(x, torch.arange(6.0) * 2)
    assert world1.broadcast_(x, 0) is x
    world1.barrier()
    assert world1.broadcast_object({"a": [1]}) == {"a": [1]}
    assert world1.allgather_object(3) == [3]
    out, received = world1.alltoall(x, splits=[6])
    assert torch.equal(out, x) and received.tolist() == [6]


class _Busy:
    works = []

    def done(self):
        return False


def _expect(fn, exc):
    try:
        fn()
    except exc as e:
        return str(e)
    raise AssertionError(f"{fn} did not raise {exc}")


@pytest.mark.parametrize("case", [
    "duplicate_name", "unknown_handle", "reducescatter_op",
    "alltoall_splits", "adasum_int", "invalid_set", "unregistered_set",
    "broadcast_root"])
def test_error_contracts_match_reference(jax_world, case):
    """The port raises what the reference raises, with its words."""
    hvd = jax_world
    x = np.ones((2, 3), np.float32)
    if case == "duplicate_name":
        tc._handles.allocate("dup", "allreduce", _Busy)
        held = jc._handles.allocate("dup", "allreduce")
        try:
            assert _expect(lambda: thvd.allreduce_async(torch.ones(2),
                                                        name="dup"),
                           ValueError) == _expect(
                lambda: jc._handles.allocate("dup", "allreduce"),
                ValueError)
        finally:
            jc._handles.complete(held)
            jc._handles.clear(held)
        return
    port, ref = {
        "unknown_handle": (lambda: thvd.synchronize(12345),
                           lambda: hvd.synchronize(12345)),
        "reducescatter_op": (lambda: thvd.reducescatter(torch.ones(2, 3),
                                                        op=thvd.Max),
                             lambda: hvd.reducescatter(x, op=hvd.Max)),
        "alltoall_splits": (lambda: thvd.alltoall(torch.ones(2, 3),
                                                  splits=[3]),
                            lambda: hvd.alltoall(x, splits=[3])),
        "adasum_int": (lambda: thvd.allreduce(torch.ones(2, dtype=torch.int32),
                                              op=thvd.Adasum),
                       lambda: hvd.allreduce(np.ones(2, np.int32),
                                             op=hvd.Adasum)),
        "invalid_set": (lambda: thvd.add_process_set([0, 1]),
                        lambda: hvd.add_process_set([0, 1])),
        "unregistered_set": (
            lambda: thvd.allreduce(torch.ones(2),
                                   process_set=thvd.ProcessSet([0])),
            lambda: hvd.allreduce(x, process_set=hvd.ProcessSet([0]))),
        "broadcast_root": (lambda: thvd.broadcast(torch.ones(2), 1),
                           lambda: hvd.broadcast(x, 1)),
    }[case]
    exc = {"unknown_handle": ValueError, "reducescatter_op": ValueError,
           "alltoall_splits": ValueError, "adasum_int": NotImplementedError,
           "invalid_set": ValueError, "unregistered_set": ValueError,
           "broadcast_root": ValueError}[case]
    assert _expect(port, exc) == _expect(ref, exc)


API = (
    "allreduce allreduce_ allreduce_async allreduce_async_ grouped_allreduce "
    "allgather allgather_async allgather_object broadcast broadcast_ "
    "broadcast_async broadcast_async_ broadcast_object reducescatter "
    "alltoall barrier join poll synchronize Average Sum Adasum Min Max "
    "ProcessSet add_process_set global_process_set Compression "
    "DistributedOptimizer DistributedGradientTape make_training_step "
    "broadcast_parameters broadcast_optimizer_state broadcast_variables "
    "init shutdown is_initialized rank size local_rank local_size "
    "cross_rank cross_size num_devices local_devices mesh topology Topology "
    "mpi_threads_supported mpi_built mpi_enabled gloo_built gloo_enabled "
    "nccl_built ddl_built mlsl_built tpu_built tpu_enabled").split()
CALLBACKS = ("Callback BroadcastGlobalVariablesCallback MetricAverageCallback "
             "LearningRateScheduleCallback LearningRateWarmupCallback "
             "warmup_schedule scaled_lr").split()


def test_package_exports_the_reference_names():
    """``import horovod_tpu_torch as hvd`` reads like the reference: every
    name of the slice exists under the reference's name, callables where
    the reference's are; grouped_allreduce_async is the port's handle
    form of the reference binding's (``horovod_tpu/torch``)."""
    import horovod_tpu as jhvd
    import horovod_tpu.callbacks as jcb
    import horovod_tpu.torch as jt
    for name in API:
        ref = getattr(jhvd, name)
        assert callable(getattr(thvd, name)) == callable(ref), name
    for name in CALLBACKS:
        assert getattr(thvd, name) is getattr(thvd.callbacks, name)
        assert callable(getattr(jcb, name))
    assert callable(thvd.grouped_allreduce_async)
    assert callable(jt.grouped_allreduce_async)
