"""The port's sequence parallelism against the JAX package's, on the CPU.

The same seeded inputs (numpy ``default_rng``) go through ring,
ring-flash and Ulysses attention at 4 ranks, causal and not, with and
without packed segment ids (borders off the shard edges, one segment
wholly inside shard 1): the port's on 4 gloo processes (one job for the
module), the JAX package's under ``shard_map`` on 4 of the conftest's CPU
devices.  Ring-flash is held to JAX ``ring_flash_attention`` with
``interpret=True, check_vma=False`` (as ``tests/test_parallel.py:987``);
ring and Ulysses to JAX ``local_attention`` over the whole sequence,
which the reference's own tests hold its ring and Ulysses to.  The
gradient is that of ``sum(o * w)`` for a fixed random ``w``.  Shapes: B
2, T 64 (16 a rank), H 4, D 16, f32.  Tolerances: the reference's 2e-5
for outputs and 5e-5 for gradients.

The virtual ranks of ``chip_smoke.py`` phase 11 (four threads of one
process, every exchange a swap in memory) are held to the gloo ranks'
results, and the ring-flash route's launch plan is checked with the
kernels' wrappers standing in for the card.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.parallel import sequence as jseq
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import sequence as sq
from torch_support import flash_kernels_as_plain, start_port_job

B, T, H, D, N = 2, 64, 4, 16, 4
TL = T // N
TOL = 2e-5
GRAD_TOL = 5e-5
VARIANTS = ("ring", "ring_flash", "ulysses", "ulysses_flash")
CASES = [(v, c, p) for v in VARIANTS for c in (True, False)
         for p in (False, True)]


def _case_id(case):
    v, c, p = case
    return f"{v}-{'causal' if c else 'full'}-{'packed' if p else 'plain'}"


def _inputs():
    rng = np.random.default_rng(5)
    q, k, v, w = (rng.standard_normal((B, T, H, D)).astype(np.float32)
                  for _ in range(4))
    seg = np.zeros((B, T), np.int32)
    seg[0, 23:] = 1
    seg[1, 9:20] = 1
    seg[1, 20:30] = 2           # wholly inside shard 1
    seg[1, 30:] = 3
    return dict(q=q, k=k, v=v, w=w, seg=seg)


JOB = r'''
import os, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import sequence as sq
from horovod_tpu_torch.topology import build_mesh

out = sys.argv[1]
hvd.init(device="cpu")
r = hvd.rank()
x = dict(np.load(os.path.join(out, "inputs.npz")))
mesh = build_mesh(axes=("seq",), shape=(4,))
axis = mesh.axis("seq")
assert mesh.axis_index("seq") == sq.axis_index(axis) == r
sl = slice(r * %(tl)d, (r + 1) * %(tl)d)
fns = {"ring": sq.ring_attention, "ring_flash": sq.ring_flash_attention,
       "ulysses": sq.ulysses_attention,
       "ulysses_flash": lambda *a, **kw: sq.ulysses_attention(
           *a, use_flash=True, **kw)}
res = {}
for variant, causal, packed in %(cases)r:
    ins = [torch.from_numpy(x[n][:, sl]).requires_grad_() for n in "qkv"]
    seg = torch.from_numpy(x["seg"][:, sl]) if packed else None
    o = fns[variant](*ins, axis, causal, segment_ids=seg)
    grads = torch.autograd.grad((o * torch.from_numpy(x["w"][:, sl])).sum(),
                                ins)
    key = f"{variant}/{causal}/{packed}"
    res[key + "/o"] = o.detach().numpy()
    for n, g in zip(("dq", "dk", "dv"), grads):
        res[key + "/" + n] = g.numpy()
np.savez(os.path.join(out, f"rank{r}.npz"), **res)
hvd.shutdown()
'''


def _jax_case(x, variant, causal, packed, mesh4):
    """Output and (dq, dk, dv) of the JAX side, whole sequence."""
    q, k, v, w = (jnp.asarray(x[n]) for n in "qkvw")
    seg = jnp.asarray(x["seg"]) if packed else None
    if variant == "ring_flash":
        specs = (P(None, "seq"),) * (4 if packed else 3)
        smapped = jax.shard_map(
            lambda q, k, v, *s: jseq.ring_flash_attention(
                q, k, v, "seq", causal, None, True, *s),
            mesh=mesh4, in_specs=specs, out_specs=P(None, "seq"),
            check_vma=False)
        fn = jax.jit(lambda q, k, v: smapped(q, k, v,
                                             *(() if seg is None else
                                               (seg,))))
    else:
        fn = functools.partial(jseq.local_attention, causal=causal,
                               segment_ids=seg)
    o, vjp = jax.vjp(fn, q, k, v)
    return np.asarray(o), [np.asarray(g) for g in vjp(w)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The port's gloo ranks (started first) and the JAX side, computed
    while they run; by case, the port's arrays joined over the ranks."""
    out = tmp_path_factory.mktemp("seq")
    x = _inputs()
    np.savez(out / "inputs.npz", **x)
    finish = start_port_job(JOB % dict(tl=TL, cases=CASES), str(out),
                            np_=N, timeout=300)
    mesh4 = Mesh(np.array(jax.devices()[:N]), ("seq",))
    want = {case: _jax_case(x, *case, mesh4) for case in CASES}
    ranks, _ = finish()
    got = {}
    for case in CASES:
        key = "/".join(map(str, case))
        got[case] = [np.concatenate([r[f"{key}/{n}"] for r in ranks], 1)
                     for n in ("o", "dq", "dk", "dv")]
    return x, got, want


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_output_matches_jax(results, case):
    _, got, want = results
    np.testing.assert_allclose(got[case][0], want[case][0], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_gradients_match_jax(results, case):
    _, got, want = results
    for name, a, b in zip(("dq", "dk", "dv"), got[case][1:], want[case][1]):
        np.testing.assert_allclose(a, b, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def _virtual(x, variant, causal, packed):
    """The phase-11 mechanism on CPU tensors: four threads, the package's
    functions between in-memory exchanges.  Ring and Ulysses take one
    backward over every rank's output; ring-flash's passes are called
    directly.  Returns o, dq, dk, dv joined over the ranks."""
    t = {n: torch.from_numpy(x[n]) for n in ("q", "k", "v", "w", "seg")}

    def shard(name, i):
        return t[name][:, i * TL:(i + 1) * TL]

    ins = [[shard(n, i).clone().requires_grad_() for n in "qkv"]
           for i in range(N)]
    axis = sq.VirtualAxis(N)

    def rank(ax):
        i = ax.index
        seg = shard("seg", i) if packed else None
        if variant == "ring_flash":
            o, res = sq._ring_flash_fwd(*(x.detach() for x in ins[i]), ax,
                                        causal, D ** -0.5, seg)
            return (o,) + sq._ring_flash_bwd(ax, causal, D ** -0.5, res,
                                             shard("w", i))
        fn = {"ring": sq.ring_attention,
              "ulysses": sq.ulysses_attention}[variant]
        return fn(*ins[i], ax, causal, segment_ids=seg)

    outs = axis.run(rank)
    if variant == "ring_flash":
        return [torch.cat([o[j] for o in outs], 1).numpy()
                for j in range(4)]
    loss = sum((o * shard("w", i)).sum() for i, o in enumerate(outs))
    grads = torch.autograd.grad(loss, [g for r in ins for g in r])
    return [torch.cat(outs, 1).detach().numpy()] + [
        torch.cat(grads[j::3], 1).numpy() for j in range(3)]


VIRTUAL_CASES = [c for c in CASES if c[0] != "ulysses_flash"]


@pytest.mark.parametrize("case", VIRTUAL_CASES, ids=_case_id)
def test_virtual_ranks_match_gloo_ranks(results, case):
    """The same functions with the exchanges swapped for in-memory ones
    give the gloo ranks' values: ring-flash's passes bit for bit (the
    same calls in the same order), ring and Ulysses within 1e-6 (one
    backward over four ranks' graphs sums in another order)."""
    x, got, _ = results
    virtual = _virtual(x, *case)
    for name, a, b in zip(("o", "dq", "dk", "dv"), virtual, got[case]):
        if case[0] == "ring_flash":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       err_msg=name)


def _fake_card(monkeypatch):
    """The flash wrappers as if the tensors lay on the card: the route
    says "cuda", each launch counts by virtual rank and computes with the
    plain versions, and the plain route itself raises, so a ring step
    that fell back to it would fail."""
    plain_fwd, plain_bwd = fa._fwd_parts_plain, fa._bwd_parts_plain
    counts, lock = {}, threading.Lock()

    def note(kind, qseg, kseg):
        key = (threading.current_thread().name, kind)
        with lock:
            n, rotated = counts.get(key, (0, 0))
            counts[key] = (n + 1, rotated + (kseg is not qseg))

    def launch_fwd(q, k, v, qseg, kseg, causal, scale):
        note("fwd", qseg, kseg)
        b, _, h, _ = q.shape
        o, m, l = plain_fwd(fa._fold(q), fa._fold(k), fa._fold(v), qseg,
                            kseg, causal, scale)
        return fa._unfold(o, b, h), m[:, 0], l[:, 0]

    def launch_bwd(kind):
        def launch(q, k, v, o, do, m, l, qseg, kseg, causal, scale):
            note(kind, qseg, kseg)
            b, _, h, _ = q.shape
            g = [fa._unfold(x, b, h) for x in plain_bwd(
                *(fa._fold(x) for x in (q, k, v, o, do)), m, l, qseg, kseg,
                causal, scale)]
            return g[0] if kind == "dq" else (g[1], g[2])
        return launch

    def refuse(*a, **kw):
        raise AssertionError("a plain version ran on the card's route")

    monkeypatch.setattr(fa, "_route", lambda x: "cuda")
    monkeypatch.setattr(fa, "_launch_fwd", launch_fwd)
    monkeypatch.setattr(fa, "_launch_dq", launch_bwd("dq"))
    monkeypatch.setattr(fa, "_launch_dkv", launch_bwd("dkv"))
    monkeypatch.setattr(fa, "_fwd_parts_plain", refuse)
    monkeypatch.setattr(fa, "_bwd_parts_plain", refuse)
    return counts


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("packed", [False, True])
def test_ring_flash_launch_plan(results, monkeypatch, causal, packed):
    """On the card's route every ring step launches the kernels (never the
    plain versions): per rank i, 1 + i forward, dQ and dK/dV launches
    under causal (the fully masked steps launch nothing), 4 of each
    without; every off-diagonal launch takes the rotated k-side ids; and
    the values are still the gloo ranks'."""
    x, got, _ = results
    counts = _fake_card(monkeypatch)
    virtual = _virtual(x, "ring_flash", causal, packed)
    for i in range(N):
        want = 1 + i if causal else N
        for kind in ("fwd", "dq", "dkv"):
            n, rotated = counts[(f"virtual-rank-{i}", kind)]
            assert n == want, (i, kind, n)
            assert rotated == (want - 1 if packed else 0), (i, kind)
    for a, b in zip(virtual, got[("ring_flash", causal, packed)]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype,d,err", [
    (torch.float64, 16, TypeError), (torch.bfloat16, 0, ValueError)])
def test_ring_flash_refuses_what_the_kernels_refuse(monkeypatch, dtype, d,
                                                    err):
    """On the card's route f64 inputs and an empty head dim raise as
    ``flash_attention`` does, before any block moves; nothing falls back
    to a plain version.  (Head dims above 256 plan the wide instances:
    test_ring_flash_d512_on_the_cards_route_matches_jax.)"""
    monkeypatch.setattr(fa, "_route", lambda x: "cuda")
    q = torch.zeros((1, 16, 2, d), dtype=dtype)
    with pytest.raises(err):
        sq.VirtualAxis(2).run(lambda ax: sq.ring_flash_attention(
            q, q, q, ax))


def _ring_flash_on_the_cards_route(monkeypatch, d, d_kernel):
    """Ring-flash in f32 at 2 virtual ranks on the card's route, causal and
    packed, head dim ``d``: every launch takes the f32 kernels at head dim
    ``d_kernel`` (the plan pads; the kernel calls compute with the plain
    versions here), 1 + i of each kernel on rank i, and o and the
    gradients equal JAX ``ring_flash_attention`` on 2 CPU devices
    (interpret mode)."""
    n, h = 2, 2
    tl, scale = T // n, d ** -0.5
    rng = np.random.default_rng(9)
    x = dict(zip("qkvw", (rng.standard_normal((B, T, h, d)).astype(
        np.float32) for _ in range(4))))
    x["seg"] = np.zeros((B, T), np.int32)
    x["seg"][:, 40:] = 1            # a border inside shard 1
    want_o, want_g = _jax_case(x, "ring_flash", True, True,
                               Mesh(np.array(jax.devices()[:n]), ("seq",)))
    seen = flash_kernels_as_plain(monkeypatch)
    t = {name: torch.from_numpy(a) for name, a in x.items()}

    def rank(ax):
        sl = slice(ax.index * tl, (ax.index + 1) * tl)
        q, k, v, w, seg = (t[name][:, sl] for name in ("q", "k", "v", "w",
                                                       "seg"))
        with torch.no_grad():
            o = sq.ring_flash_attention(q, k, v, ax, True,
                                        segment_ids=seg)
        o2, res = sq._ring_flash_fwd(q, k, v, ax, True, scale, seg)
        assert torch.equal(o, o2) and o.dtype == torch.float32
        return (o,) + sq._ring_flash_bwd(ax, True, scale, res, w)

    outs = sq.VirtualAxis(n).run(rank)
    got = [torch.cat([o[j] for o in outs], 1).numpy() for j in range(4)]
    assert {(kind, inst, shape[-1]) for kind, inst, shape in seen} == {
        (kind, "f32", d_kernel) for kind in ("fwd", "bwd_dq", "bwd_dkv")}
    launches = [kind for kind, _, _ in seen]
    assert (launches.count("fwd"), launches.count("bwd_dq"),
            launches.count("bwd_dkv")) == (2 * 3, 3, 3)
    np.testing.assert_allclose(got[0], want_o, rtol=TOL, atol=TOL)
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want_g):
        np.testing.assert_allclose(a, b, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_ring_flash_f32_on_the_cards_route_matches_jax(monkeypatch):
    _ring_flash_on_the_cards_route(monkeypatch, 80, 128)


def test_ring_flash_d512_on_the_cards_route_matches_jax(monkeypatch):
    """Head dim 512: the wide instances, unpadded."""
    _ring_flash_on_the_cards_route(monkeypatch, 512, 512)


def test_ulysses_heads_must_divide_the_axis():
    q = torch.zeros((1, 8, 4, 16))
    with pytest.raises(ValueError, match="divisible by axis size"):
        sq.VirtualAxis(3).run(lambda ax: sq.ulysses_attention(q, q, q, ax))


@pytest.mark.parametrize("seg,match", [
    (torch.zeros((1, 8), dtype=torch.int32), r"\[B, T_local\]"),
    (torch.zeros((1, 16)), "integer")])
def test_ring_flash_checks_segment_ids(seg, match):
    q = torch.zeros((1, 16, 2, 16))
    with pytest.raises(ValueError, match=match):
        sq.ring_flash_attention(q, q, q, sq.VirtualRank(sq.VirtualAxis(1),
                                                        0),
                                segment_ids=seg)


def test_virtual_axis_raises_a_rank_error_without_hanging():
    """One rank failing breaks the barrier: the others stop and the
    failing rank's error reaches the caller."""
    def rank(ax):
        if ax.index == 1:
            raise KeyError("rank 1 failed")
        return ax.axis.exchange(ax.index, ax.index)

    with pytest.raises(KeyError, match="rank 1 failed"):
        sq.VirtualAxis(3, timeout=30).run(rank)
