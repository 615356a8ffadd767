"""The port's transformer LM against the JAX package's, on the CPU.

The same seeded parameters (numpy ``default_rng``, crossed with
``convert.lm_params_to_torch``) and tokens go through
``horovod_tpu.models.transformer`` (flash attention in Pallas interpret
mode) and ``horovod_tpu_torch.models.transformer`` (the plain versions of
the flash kernels on CPU tensors).  Config: vocab 64, d_model 32, 2 heads,
2 layers, d_ff 64, T 32.  Tolerances: f32 logits, loss and gradients
1e-4; bf16 logits 2e-2; params after one training step 1e-5 and the bf16
momentum within one bf16 ulp.
"""

import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

from horovod_tpu.models import transformer as jtfm
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.topology import build_mesh as jax_build_mesh
import horovod_tpu_torch as thvd
from horovod_tpu_torch import benchmark
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.ops import fusion as tfusion
from horovod_tpu_torch.optim import SGD

T = 32
LR = 0.1
TOL = 1e-4
BF16_TOL = 2e-2
STEP_TOL = 1e-5

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(dtype="float32", t=T, n_layers=2):
    kw = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=n_layers,
              d_ff=64, max_seq=t)
    return (jtfm.TransformerConfig(dtype=_JDT[dtype], **kw),
            tfm.TransformerConfig(dtype=_TDT[dtype], **kw))


def _params(cfg, seed=0):
    """Seeded f32 parameters in the JAX tree layout (numpy), at the scales
    of the reference's ``init_params``, with RMSNorm scales away from one
    so their path is exercised."""
    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, cfg.d_ff

    def dense(shape, scale=None):
        return (rng.standard_normal(shape) * (scale or shape[0] ** -0.5)
                ).astype(np.float32)

    def norm():
        return (1.0 + 0.2 * rng.standard_normal(d)).astype(np.float32)

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


def _tokens(b=2, t=T, seed=1):
    toks = np.random.default_rng(seed).integers(0, 64, (b, t + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _port_model(tcfg, params):
    model = tfm.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(convert.lm_params_to_torch(params))
    return model


def _jtree(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _names(tree):
    """``{dotted name: leaf}`` of a JAX params tree, in flatten order."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        out[".".join(parts)] = leaf
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attention", ["flash", "local", "auto"])
def test_logits_match_jax(attention, dtype):
    jcfg, tcfg = _cfgs(dtype)
    params = _params(jcfg)
    tokens, _ = _tokens()
    want = np.asarray(jtfm.forward(_jtree(params), jnp.asarray(tokens), jcfg,
                                   attention=attention))
    got = tfm.forward(_port_model(tcfg, params).tree(),
                      torch.from_numpy(tokens), tcfg, attention=attention)
    assert got.dtype == torch.float32 and got.shape == (2, T, 64)
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("min_t,route", [(None, "local"), ("128", "flash")])
def test_auto_route_matches_jax(monkeypatch, min_t, route):
    """``auto`` picks flash from HOROVOD_FLASH_AUTO_MIN_T up (T=128 tiles
    the 128-row blocks), local below; the logits match JAX's either way."""
    if min_t is not None:
        monkeypatch.setenv("HOROVOD_FLASH_AUTO_MIN_T", min_t)
    calls = []
    real = tfm.flash_attention
    monkeypatch.setattr(tfm, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    jcfg, tcfg = _cfgs(t=128)
    params = _params(jcfg)
    tokens, _ = _tokens(b=1, t=128)
    want = np.asarray(jtfm.forward(_jtree(params), jnp.asarray(tokens), jcfg,
                                   attention="auto"))
    got = tfm.forward(_port_model(tcfg, params).tree(),
                      torch.from_numpy(tokens), tcfg, attention="auto")
    assert bool(calls) == (route == "flash")
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("t,min_t", [(512, None), (1024, None),
                                     (1000, None), (2048, None),
                                     (1100, None), (64, "16"), (96, "16"),
                                     (128, "128")])
def test_flash_profitable_rule_matches_jax(monkeypatch, t, min_t):
    if min_t is not None:
        monkeypatch.setenv("HOROVOD_FLASH_AUTO_MIN_T", min_t)
    assert tfm._flash_profitable(t) == jtfm._flash_profitable(t)


def test_packed_segments_match_jax():
    jcfg, tcfg = _cfgs()
    params = _params(jcfg)
    tokens, _ = _tokens(b=1)
    seg = np.concatenate([np.zeros(12), np.ones(20)]).astype(np.int32)[None]
    for attention in ("flash", "local"):
        want = np.asarray(jtfm.forward(_jtree(params), jnp.asarray(tokens),
                                       jcfg, attention=attention,
                                       segment_ids=jnp.asarray(seg)))
        got = tfm.forward(_port_model(tcfg, params).tree(),
                          torch.from_numpy(tokens), tcfg,
                          attention=attention,
                          segment_ids=torch.from_numpy(seg))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                                   atol=TOL, err_msg=attention)


@pytest.mark.parametrize("attention", ["flash", "local"])
def test_loss_and_grads_match_jax(attention):
    jcfg, tcfg = _cfgs()
    params = _params(jcfg)
    tokens, labels = _tokens()
    jloss, jgrads = jax.value_and_grad(jtfm.loss_fn)(
        _jtree(params), jnp.asarray(tokens), jnp.asarray(labels), jcfg,
        None, None, attention)
    model = _port_model(tcfg, params)
    loss = tfm.loss_fn(model.tree(), torch.from_numpy(tokens),
                       torch.from_numpy(labels), tcfg, attention=attention)
    named = convert.lm_ordered_parameters(model)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL,
                               atol=TOL)
    want = _names(jgrads)
    assert [n for n, _ in named] == list(want)
    for (name, _), g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   rtol=TOL, atol=TOL, err_msg=name)


def _bf16_ulp_close(got, want, name):
    """|got - want| <= one bf16 ulp of the larger magnitude, plus the f32
    gradients' own disagreement (STEP_TOL) for entries near zero, where a
    bf16 ulp is smaller than that."""
    got, want = (np.asarray(x, np.float32) for x in (got, want))
    ulp = np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7
    bad = np.abs(got - want) > ulp + STEP_TOL
    assert not bad.any(), (name, got[bad][:5], want[bad][:5])


def _jax_train(params, tokens, labels, n_devices, attention, seg=None,
               steps=1):
    jcfg, _ = _cfgs()
    mesh = jax_build_mesh(axes=("data",), shape=(n_devices,),
                          devices=jax.devices()[:n_devices])
    opt = optax.sgd(LR, momentum=0.9, accumulator_dtype=jnp.bfloat16)
    step, _, _ = jtfm.make_train_step(jcfg, opt, mesh, data_axis="data",
                                      attention=attention, donate=False,
                                      packed=seg is not None)
    p = _jtree(params)
    state = opt.init(p)
    extra = () if seg is None else (jnp.asarray(seg),)
    for _ in range(steps):
        p, state, loss = step(p, state, jnp.asarray(tokens),
                              jnp.asarray(labels), *extra)
    return float(loss), _names(p), _names(state[0].trace)


@pytest.fixture()
def port_world():
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


def _port_train(params, tokens, labels, attention, mesh, seg=None,
                steps_per_call=1):
    _, tcfg = _cfgs()
    model = _port_model(tcfg, params)
    named = convert.lm_ordered_parameters(model)
    opt = SGD([p for _, p in named], LR, momentum=0.9,
              accumulator_dtype=torch.bfloat16)
    step = tfm.make_train_step(model, opt, mesh, attention=attention,
                               packed=seg is not None,
                               steps_per_call=steps_per_call)
    extra = () if seg is None else (torch.from_numpy(seg),)
    loss = step(torch.from_numpy(tokens), torch.from_numpy(labels), *extra)
    return (float(loss), {n: p.detach().numpy() for n, p in named},
            {n: opt.trace[i].float().numpy()
             for i, (n, _) in enumerate(named)})


@pytest.mark.parametrize("attention", ["flash", "local"])
def test_train_step_matches_jax(port_world, attention):
    """One step with bf16-momentum SGD on one rank and one device."""
    jcfg, _ = _cfgs()
    params = _params(jcfg)
    tokens, labels = _tokens()
    jloss, jparams, jtrace = _jax_train(params, tokens, labels, 1, attention)
    loss, got, trace = _port_train(params, tokens, labels, attention,
                                   thvd.mesh())
    np.testing.assert_allclose(loss, jloss, rtol=TOL, atol=TOL)
    assert list(got) == list(jparams) == list(trace)
    for name in jparams:
        np.testing.assert_allclose(got[name], np.asarray(jparams[name]),
                                   rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=name)
        _bf16_ulp_close(trace[name], jtrace[name], name)


def test_packed_train_step_matches_jax(port_world):
    """packed=True threads segment ids into the step, as the reference's
    ``make_train_step(packed=True)`` does."""
    jcfg, _ = _cfgs()
    params = _params(jcfg)
    tokens, labels = _tokens()
    seg = np.repeat(np.concatenate([np.zeros(10), np.ones(22)])[None], 2,
                    axis=0).astype(np.int32)
    jloss, jparams, _ = _jax_train(params, tokens, labels, 1, "flash", seg)
    loss, got, _ = _port_train(params, tokens, labels, "flash", thvd.mesh(),
                               seg)
    np.testing.assert_allclose(loss, jloss, rtol=TOL, atol=TOL)
    for name in jparams:
        np.testing.assert_allclose(got[name], np.asarray(jparams[name]),
                                   rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=name)


def test_steps_per_call_runs_that_many_steps_on_one_batch(port_world):
    """steps_per_call=2 is two steps on the same batch (the second uses the
    bf16 momentum), as the reference's scanned steps are."""
    jcfg, _ = _cfgs()
    params = _params(jcfg)
    tokens, labels = _tokens()
    jloss, jparams, jtrace = _jax_train(params, tokens, labels, 1, "local",
                                        steps=2)
    loss, got, trace = _port_train(params, tokens, labels, "local",
                                   thvd.mesh(), steps_per_call=2)
    np.testing.assert_allclose(loss, jloss, rtol=TOL, atol=TOL)
    for name in jparams:
        # The second step's update reads the bf16 momentum, where a one-ulp
        # difference in the first step's rounding moves a param by up to
        # lr * 0.9 * ulp: hold to the bf16 tolerance.
        np.testing.assert_allclose(got[name], np.asarray(jparams[name]),
                                   rtol=BF16_TOL * LR, atol=BF16_TOL * LR,
                                   err_msg=name)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _train_worker(rank, size, addr, out_dir):
    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    os.environ["HOROVOD_COORDINATOR_ADDR"] = addr
    thvd.init(device="cpu")
    try:
        jcfg, _ = _cfgs()
        tokens, labels = _tokens(b=2 * size)
        rows = slice(2 * rank, 2 * rank + 2)
        loss, got, _ = _port_train(_params(jcfg), tokens[rows],
                                   labels[rows], "flash", thvd.mesh())
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 loss=np.float32(loss), **got)
    finally:
        thvd.shutdown()


def test_two_rank_gloo_step_matches_jax(tmp_path):
    """One step over 2 gloo ranks on the halves of a global batch.  Data
    parallelism must equal one step on the whole batch: the params on
    every rank match the JAX step on one device and the global batch.
    The mean loss matches the 2-device JAX mesh's.  The params are not
    held to the 2-device mesh's: its LM step applies the SUM of the
    per-device gradients, twice the mean at 2 devices (the gradient of a
    replicated param inside the vma-checked shard_map already arrives
    psummed, and the fused pmean keeps it), a divergence of the reference
    recorded in ROADMAP.md Queue 3."""
    addr = f"127.0.0.1:{_free_port()}"
    mp.start_processes(_train_worker, args=(2, addr, str(tmp_path)),
                       nprocs=2, start_method="spawn")
    jcfg, _ = _cfgs()
    tokens, labels = _tokens(b=4)
    _, jparams, _ = _jax_train(_params(jcfg), tokens, labels, 1, "flash")
    jloss2, _, _ = _jax_train(_params(jcfg), tokens, labels, 2, "flash")
    for rank in range(2):
        got = dict(np.load(tmp_path / f"rank{rank}.npz"))
        np.testing.assert_allclose(got.pop("loss"), jloss2, rtol=TOL,
                                   atol=TOL)
        assert sorted(got) == sorted(jparams)
        for name, want in jparams.items():
            np.testing.assert_allclose(got[name], np.asarray(want),
                                       rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=f"rank{rank} {name}")


@pytest.mark.parametrize("acc", ["bfloat16", "float32", None])
def test_sgd_matches_optax(acc):
    """Three steps of the port's SGD against optax's on the same gradients:
    the bf16 trace rounds ``0.9 * trace`` in bf16 and stores the f32 sum
    rounded, while the update uses the unrounded sum."""
    rng = np.random.default_rng(5)
    shapes = [(7, 5), (11,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    jacc = None if acc is None else _JDT[acc]
    opt = optax.sgd(LR, momentum=0.9, accumulator_dtype=jacc)
    jp = [jnp.asarray(x) for x in p0]
    state = opt.init(jp)
    params = [torch.from_numpy(x.copy()) for x in p0]
    topt = SGD(params, LR, momentum=0.9,
               accumulator_dtype=None if acc is None else _TDT[acc])
    for g in grads:
        upd, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step([torch.from_numpy(x) for x in g])
    for a, b in zip(params, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    for i, t in enumerate(state[0].trace):
        assert str(topt.trace[i].dtype).endswith(acc or "float32")
        np.testing.assert_array_equal(topt.trace[i].float().numpy(),
                                      np.asarray(t, np.float32))


@pytest.mark.parametrize("n_layers", [10, 12])
def test_gradient_leaf_order_and_buckets(n_layers):
    """The port's leaves follow JAX's flatten order: list items by index,
    so from 11 layers on ``layers.10`` comes after ``layers.9`` (a string
    sort would put it after ``layers.1``), and the fusion buckets are the
    reference's (10 layers: the benchmark of record's depth)."""
    jcfg, tcfg = _cfgs(n_layers=n_layers)
    named = convert.lm_ordered_parameters(tfm.TransformerLM(tcfg,
                                                            device="cpu"))
    abstract = jtfm.init_abstract(jcfg)
    want = _names(abstract)
    names = [n for n, _ in named]
    assert names == list(want)
    last = f"layers.{n_layers - 1}.wv"
    assert names.index(last) == names.index("ln_f_scale") - 1
    leaves = [p for _, p in named]
    jleaves = [np.zeros(x.shape, np.float32) for x in want.values()]
    for threshold in (4096, 20000, 1 << 26):
        assert (tfusion._bucket_leaves(leaves, threshold)
                == [list(b) for b in jfusion._bucket_leaves(jleaves,
                                                            threshold)])


def test_converter_round_trip():
    jcfg, tcfg = _cfgs()
    params = _params(jcfg)
    model = _port_model(tcfg, params)
    back = convert.lm_state_dict_to_params(model.state_dict())
    assert _names(back).keys() == _names(params).keys()
    for name, want in _names(params).items():
        np.testing.assert_array_equal(_names(back)[name], want)


@pytest.mark.parametrize("kw,match", [
    (dict(compression="int8"), "rides the ZeRO reduce-scatter wire"),
    (dict(compression="fp16"), "rides the ZeRO reduce-scatter wire"),
])
def test_routes_not_ported_raise(port_world, kw, match):
    """Every route runs (ZeRO-1 and its codecs too: see
    ``test_run_lm_benchmark_sharded_under_every_codec``); what raises is
    what the reference refuses: a codec without the ZeRO wire."""
    with pytest.raises(NotImplementedError, match=match):
        benchmark.run_lm_benchmark(d_model=32, n_layers=1, n_heads=2,
                                   vocab_size=64, seq_len=T, batch_size=1,
                                   device="cpu", verbose=False, **kw)


@pytest.mark.parametrize("codec", ["none", "bf16", "fp16", "int8",
                                   "powersgd:2"])
def test_run_lm_benchmark_sharded_under_every_codec(port_world, codec):
    """The LM benchmark's ZeRO lane at one rank: under ``none`` the plain
    step's losses bit for bit (the scatter is the identity, the mean a
    multiply by 1.0, the flat-bucket sgd the same arithmetic); every
    codec's losses finite and within the reference's bound
    (``tests/test_compression.py``) from step 3 on; the state and wire
    bytes reported."""
    kw = dict(d_model=32, n_layers=2, n_heads=2, vocab_size=64, seq_len=T,
              batch_size=2, num_warmup_batches=1, num_batches_per_iter=1,
              num_iters=5, device="cpu", verbose=False)
    plain = benchmark.run_lm_benchmark(**kw)
    res = benchmark.run_lm_benchmark(shard_optimizer=True,
                                     compression=codec, **kw)
    assert res["shard_optimizer"] and res["compression"] == codec.split(
        ":")[0]
    got, want = res["step_losses"], plain["step_losses"]
    if codec == "none":
        assert got == want
        assert res["optimizer_state_bytes"] == plain["optimizer_state_bytes"]
    assert all(np.isfinite(got))
    for a, b in zip(want[2:], got[2:]):
        assert abs(a - b) <= 0.05 * abs(a) + 1e-3
    assert res["wire_bytes_per_step"] > 0


def _loss_and_grads(tcfg, params, attention, remat):
    model = _port_model(tcfg, params)
    tokens, labels = _tokens()
    loss = tfm.loss_fn(model.tree(), torch.from_numpy(tokens),
                       torch.from_numpy(labels), tcfg, attention=attention,
                       remat=remat)
    named = convert.lm_ordered_parameters(model)
    return loss.detach(), dict(zip(
        [n for n, _ in named],
        torch.autograd.grad(loss, [p for _, p in named])))


@pytest.mark.parametrize("attention", ["flash", "local"])
@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_changes_no_value(remat, attention):
    """The same operations on the same inputs, recomputed: the loss and
    every gradient equal remat="none"'s bit for bit."""
    jcfg, tcfg = _cfgs()
    params = _params(jcfg)
    loss0, grads0 = _loss_and_grads(tcfg, params, attention, "none")
    loss, grads = _loss_and_grads(tcfg, params, attention, remat)
    assert torch.equal(loss, loss0)
    for name, g in grads.items():
        assert torch.equal(g, grads0[name]), name


@pytest.mark.parametrize("attention", ["flash", "local"])
@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_matches_jax(remat, attention):
    """The loss and gradients under each policy against the JAX package's
    ``jax.checkpoint`` of the same policy (1e-5)."""
    jcfg, tcfg = _cfgs()
    params = _params(jcfg)
    tokens, labels = _tokens()
    jloss, jgrads = jax.value_and_grad(jtfm.loss_fn)(
        _jtree(params), jnp.asarray(tokens), jnp.asarray(labels), jcfg,
        None, None, attention, None, remat)
    loss, grads = _loss_and_grads(tcfg, params, attention, remat)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=STEP_TOL,
                               atol=STEP_TOL)
    for name, want in _names(jgrads).items():
        np.testing.assert_allclose(grads[name].numpy(), np.asarray(want),
                                   rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_reaches_the_train_step(port_world, remat):
    """make_train_step threads remat into its loss: one step under each
    policy leaves the parameters and momentum of a step without it, bit
    for bit."""
    jcfg, tcfg = _cfgs()
    params = _params(jcfg)
    tokens, labels = (torch.from_numpy(x) for x in _tokens())
    out = {}
    for policy in ("none", remat):
        model = _port_model(tcfg, params)
        named = convert.lm_ordered_parameters(model)
        opt = SGD([p for _, p in named], LR, momentum=0.9,
                  accumulator_dtype=torch.bfloat16)
        step = tfm.make_train_step(model, opt, thvd.mesh(),
                                   attention="local", remat=policy)
        loss = step(tokens, labels)
        out[policy] = (loss, [p.detach().clone() for _, p in named],
                       [t.clone() for t in opt.trace])
    (l0, p0, t0), (l1, p1, t1) = out["none"], out[remat]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(p0 + t0, p1 + t1))


def _count_launches_on_a_fake_card(monkeypatch):
    """The flash wrappers as if the tensors lay on the card: each launch
    counts as the real wrapper's does and computes with the plain
    versions."""
    from horovod_tpu_torch.ops import flash_attention as fa
    plain_fwd, plain_bwd = fa._fwd_parts_plain, fa._bwd_parts_plain

    def launch_fwd(q, k, v, qseg, kseg, causal, scale):
        fa.fwd_launches.add()
        b, _, h, _ = q.shape
        o, m, l = plain_fwd(fa._fold(q), fa._fold(k), fa._fold(v), qseg,
                            kseg, causal, scale)
        return fa._unfold(o, b, h), m[:, 0], l[:, 0]

    def launch_bwd(counter, pick):
        def launch(q, k, v, o, do, m, l, qseg, kseg, causal, scale):
            counter.add()
            b, _, h, _ = q.shape
            g = [fa._unfold(x, b, h) for x in plain_bwd(
                *(fa._fold(x) for x in (q, k, v, o, do)), m, l, qseg, kseg,
                causal, scale)]
            return pick(g)
        return launch

    monkeypatch.setattr(fa, "_route", lambda x: "cuda")
    monkeypatch.setattr(fa, "_launch_fwd", launch_fwd)
    monkeypatch.setattr(fa, "_launch_dq",
                        launch_bwd(fa.dq_launches, lambda g: g[0]))
    monkeypatch.setattr(fa, "_launch_dkv",
                        launch_bwd(fa.dkv_launches, lambda g: (g[1], g[2])))
    counters = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    for c in counters:
        c.reset()
    return counters


@pytest.mark.parametrize("remat,fwd_per_layer", [("none", 1), ("dots", 2),
                                                 ("full", 2)])
def test_remat_flash_launch_plan(monkeypatch, remat, fwd_per_layer):
    """On the card's route a forward and backward under "dots" or "full"
    recomputes each layer's forward, the flash Function's with it (its
    kernel is no aten op a policy could save): 2 forward launches a layer,
    1 dQ and 1 dK/dV, against 1/1/1 without remat.  The values stay those
    of the plain versions."""
    counters = _count_launches_on_a_fake_card(monkeypatch)
    jcfg, tcfg = _cfgs()
    params = _params(jcfg)
    loss, grads = _loss_and_grads(tcfg, params, "flash", remat)
    n = tcfg.n_layers
    assert [c.count for c in counters] == [fwd_per_layer * n, n, n]
    monkeypatch.undo()
    loss0, grads0 = _loss_and_grads(tcfg, params, "flash", "none")
    assert torch.equal(loss, loss0)
    assert all(torch.equal(g, grads0[k]) for k, g in grads.items())


def test_lm_benchmark_runs_with_remat_dots(port_world):
    """run_lm_benchmark(remat="dots") end to end on the CPU, as the
    reference's ``tests/test_models.py:65`` runs it."""
    res = benchmark.run_lm_benchmark(
        d_model=32, n_layers=2, n_heads=2, vocab_size=64, seq_len=64,
        batch_size=2, attention="local", remat="dots", num_warmup_batches=1,
        num_batches_per_iter=2, num_iters=2, device="cpu", verbose=False)
    assert res["remat"] == "dots" and np.isfinite(res["loss"])
    assert len(res["step_losses"]) == 4


@pytest.mark.parametrize("kw,err", [
    (dict(attention="sdpa", seq_axis="seq"), ValueError),
    (dict(remat="sometimes"), ValueError),
])
def test_unknown_options_raise(kw, err):
    """An unknown route raises under a sequence axis, as in the reference
    (without one the reference computes local attention for any name)."""
    _, tcfg = _cfgs()
    model = tfm.TransformerLM(tcfg, device="cpu")
    with pytest.raises(err):
        tfm.forward(model.tree(), torch.zeros((1, T), dtype=torch.long),
                    tcfg, **kw)


@pytest.mark.parametrize("attention", ["ring", "ulysses", "dense",
                                       "ring_flash"])
def test_no_sequence_axis_routes_match_jax(attention):
    """Without a sequence axis the reference computes every route name:
    ``ring``, ``ulysses`` and ``dense`` as local attention, ``ring_flash``
    with the flash kernel.  Tokens [1, 16], 1 layer, d 32, f32; tolerance
    1e-6 (the local routes agree to 0 and ring_flash to about 1e-7)."""
    jcfg, tcfg = _cfgs(t=16, n_layers=1)
    params = _params(jcfg)
    tokens, _ = _tokens(b=1, t=16)
    want = np.asarray(jtfm.forward(_jtree(params), jnp.asarray(tokens), jcfg,
                                   attention=attention))
    got = tfm.forward(_port_model(tcfg, params).tree(),
                      torch.from_numpy(tokens), tcfg, attention=attention)
    assert got.shape == (1, 16, 64)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kw", [dict(shard_optimizer=True),
                                dict(compression="int8")])
def test_train_step_options_not_ported_raise(port_world, kw):
    """ZeRO-1 with a model axis, and a codec without ZeRO-1: the
    reference's ``NotImplementedError``s word for word
    (``tests/test_torch_zero.py`` holds them to the reference's)."""
    _, tcfg = _cfgs()
    model = tfm.TransformerLM(tcfg, device="cpu")
    opt = SGD([p for _, p in convert.lm_ordered_parameters(model)], LR,
              0.9)
    if kw.get("shard_optimizer"):
        from horovod_tpu_torch.topology import build_mesh
        mesh = build_mesh(axes=("data", "model"), shape=(1, 1))
        with pytest.raises(NotImplementedError,
                           match="composes with pure data parallelism"):
            tfm.make_train_step(model, opt, mesh, model_axis="model", **kw)
        step = tfm.make_train_step(model, opt, thvd.mesh(), **kw)
        assert step.init() is step.sharded.state and opt.state is None
        return
    with pytest.raises(NotImplementedError, match="rides the ZeRO"):
        tfm.make_train_step(model, opt, thvd.mesh(), **kw)


def test_train_step_rejects_optimizer_in_another_order(port_world):
    _, tcfg = _cfgs()
    model = tfm.TransformerLM(tcfg, device="cpu")
    opt = SGD(list(model.parameters()), LR, 0.9)
    with pytest.raises(ValueError, match="pytree order"):
        tfm.make_train_step(model, opt, thvd.mesh())


@pytest.fixture()
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    thvd.shutdown()
    yield
    thvd.shutdown()


def test_lm_entry_points_without_gpu_or_device_raise(no_gpu):
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.TransformerLM(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        benchmark.run_lm_benchmark(d_model=32, n_layers=1, n_heads=2,
                                   vocab_size=64, seq_len=32, batch_size=1)
    assert not thvd.is_initialized()


def test_lm_benchmark_runs_on_cpu_only_when_asked(no_gpu):
    res = benchmark.run_lm_benchmark(
        d_model=32, n_layers=2, n_heads=2, vocab_size=64, seq_len=32,
        batch_size=2, attention="flash", num_warmup_batches=1,
        num_batches_per_iter=1, num_iters=2, device="cpu", verbose=False)
    assert res["platform"] == "cpu" and res["device"] == "cpu"
    assert res["mfu"] is None and res["max_memory_allocated"] is None
    assert len(res["step_losses"]) == 2
    assert all(np.isfinite(res["step_losses"]))
    _, tcfg = _cfgs(t=32)
    cfg = tfm.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                                n_layers=2, d_ff=128, max_seq=32)
    assert res["flops_per_step_analytic"] == benchmark.lm_train_flops(cfg, 2)


def test_lm_train_flops_matches_jax():
    """The benchmark of record's analytic count (bench.py:133-144)."""
    from horovod_tpu.benchmark import lm_train_flops as jax_flops
    kw = dict(vocab_size=32768, d_model=3072, n_heads=24, n_layers=10,
              d_ff=12288, max_seq=2048)
    assert (benchmark.lm_train_flops(tfm.TransformerConfig(**kw), 4)
            == jax_flops(jtfm.TransformerConfig(**kw), 4))


# ---------------------------------------------------------------------------
# Tensor and sequence parallelism (model_axis, seq_axis)
# ---------------------------------------------------------------------------
# The tiny LM of tests/test_parallel.py:370 (vocab 64, d_model 32, 4 heads,
# 2 layers, d_ff 64, f32), tokens [4, 32] from default_rng(9).  The
# forward under model x seq = 2 x 2 (4 gloo ranks) and the dp x tp x sp
# step at 2 x 2 x 2 (8 gloo ranks) run in one module fixture, while the
# JAX single-device oracles are computed.

PAR_T = 32
PAR_ROUTES = ("ring", "ring_flash", "ulysses", "auto")
PAR_PACKED = ("ring", "ring_flash", "ulysses")
STEP_ROUTES = ("ring_flash", "ring", "ulysses")
PAR_LR = 0.1


def _par_cfgs():
    kw = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq=PAR_T)
    return (jtfm.TransformerConfig(dtype=jnp.float32, **kw),
            tfm.TransformerConfig(dtype=torch.float32, **kw))


def _par_data():
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 64, (4, PAR_T + 1)).astype(np.int32)
    seg = np.zeros((4, PAR_T), np.int32)
    seg[:, 11:] = 1             # crosses the seq shards' border at 16
    seg[:, 20:27] = 2           # wholly inside seq shard 1
    seg[:, 27:] = 3
    return dict(tokens=toks[:, :-1], labels=toks[:, 1:], seg=seg)


PAR_JOB = r'''
import os, pickle, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.optim import SGD
from horovod_tpu_torch.topology import build_mesh

out, kind = sys.argv[1], os.environ["PAR_KIND"]
hvd.init(device="cpu")
r = hvd.rank()
with open(os.path.join(out, "..", "lm.pkl"), "rb") as fh:
    params, x = pickle.load(fh)
cfg = tfm.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                            n_layers=2, d_ff=64, max_seq=%(t)d,
                            dtype=torch.float32)
res = {}
if kind == "forward":
    mesh = build_mesh(axes=("model", "seq"), shape=(2, 2))
    mg, sg = mesh.axis("model"), mesh.axis("seq")
    s = mesh.axis_index("seq")
    cols = slice(s * %(t)d // 2, (s + 1) * %(t)d // 2)
    model = tfm.TransformerLM(cfg, device="cpu", model_shards=2)
    model.load_state_dict(convert.lm_params_to_shards(params, mesh))
    toks = torch.from_numpy(x["tokens"][:, cols])
    seg = torch.from_numpy(x["seg"][:, cols])
    for route in %(routes)r:
        res[route] = tfm.forward(model.tree(), toks, cfg, mg, sg,
                                 route).detach().numpy()
    for route in %(packed)r:
        res[route + "/packed"] = tfm.forward(
            model.tree(), toks, cfg, mg, sg, route,
            segment_ids=seg).detach().numpy()
else:
    mesh = build_mesh(axes=("data", "model", "seq"), shape=(2, 2, 2))
    d, s = mesh.axis_index("data"), mesh.axis_index("seq")
    rows = slice(d * 2, d * 2 + 2)
    cols = slice(s * %(t)d // 2, (s + 1) * %(t)d // 2)
    toks = torch.from_numpy(x["tokens"][rows, cols])
    labs = torch.from_numpy(x["labels"][rows, cols])
    for route in %(step_routes)r:
        model = tfm.TransformerLM(cfg, device="cpu", model_shards=2)
        model.load_state_dict(convert.lm_params_to_shards(params, mesh))
        named = convert.lm_ordered_parameters(model)
        opt = SGD([p for _, p in named], %(lr)r, momentum=0.9)
        step = tfm.make_train_step(model, opt, mesh, "data", "model", "seq",
                                   attention=route)
        res[route + "/loss"] = np.array([float(step(toks, labs))
                                         for _ in range(2)])
        trees = {"param": model.state_dict(),
                 "trace": {n: t for (n, _), t in zip(named, opt.trace)}}
        for what, sd in trees.items():
            full = convert.lm_shards_to_params(sd, mesh)
            for k, v in full.items():
                if k != "layers":
                    res[f"{route}/{what}/{k}"] = v
            for i, layer in enumerate(full["layers"]):
                for leaf, v in layer.items():
                    res[f"{route}/{what}/layers.{i}.{leaf}"] = v
np.savez(os.path.join(out, f"rank{r}.npz"), **res)
hvd.shutdown()
'''


def _jax_two_steps(params, x):
    """Two steps of the JAX LM on one device and the global batch: loss,
    gradient, optax SGD with an f32 momentum."""
    jcfg, _ = _par_cfgs()
    opt = optax.sgd(PAR_LR, momentum=0.9)
    p = _jtree(params)
    state = opt.init(p)
    losses = []
    for _ in range(2):
        loss, g = jax.value_and_grad(jtfm.loss_fn)(
            p, jnp.asarray(x["tokens"]), jnp.asarray(x["labels"]), jcfg)
        upd, state = opt.update(g, state, p)
        p = optax.apply_updates(p, upd)
        losses.append(float(loss))
    return np.array(losses), _names(p), _names(state[0].trace)


@pytest.fixture(scope="module")
def parallel_results(tmp_path_factory):
    import pickle

    from torch_support import start_port_job
    root = tmp_path_factory.mktemp("lm_par")
    jcfg, _ = _par_cfgs()
    params, x = _params(jcfg, seed=3), _par_data()
    with open(root / "lm.pkl", "wb") as fh:
        pickle.dump((params, x), fh)
    script = PAR_JOB % dict(t=PAR_T, routes=PAR_ROUTES, packed=PAR_PACKED,
                            step_routes=STEP_ROUTES, lr=PAR_LR)
    jobs = {}
    for kind, n in (("forward", 4), ("step", 8)):
        (root / kind).mkdir()
        jobs[kind] = start_port_job(script, str(root / kind), np_=n,
                                    timeout=300,
                                    env={"PAR_KIND": kind,
                                         "OMP_NUM_THREADS": "1"})
    jp, jt = _jtree(params), jnp.asarray(x["tokens"])
    want = {"logits": np.asarray(jtfm.forward(jp, jt, jcfg)),
            "packed": np.asarray(jtfm.forward(
                jp, jt, jcfg, segment_ids=jnp.asarray(x["seg"]))),
            "step": _jax_two_steps(params, x)}
    got = {kind: finish()[0] for kind, finish in jobs.items()}
    return want, got


@pytest.mark.parametrize("route", PAR_ROUTES + tuple(
    r + "/packed" for r in PAR_PACKED))
def test_model_seq_forward_matches_jax(parallel_results, route):
    """Logits under model x seq = 2 x 2 (Megatron shards, sequence
    chunks, position offset axis_index * T_local) against the JAX
    single-device forward on the same converted params; every model rank
    of a seq shard has the same logits.  rtol 5e-4 as
    ``tests/test_parallel.py:383``."""
    want, got = parallel_results
    ranks = got["forward"]
    ref = want["packed" if route.endswith("/packed") else "logits"]
    for m in range(2):
        # mesh (model, seq): rank = 2 * model + seq
        joined = np.concatenate([ranks[2 * m + s][route] for s in range(2)],
                                1)
        np.testing.assert_allclose(joined, ref, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("what", ["loss", "param", "trace"])
@pytest.mark.parametrize("route", STEP_ROUTES)
def test_dp_tp_sp_step_matches_single_device_jax(parallel_results, route,
                                                 what):
    """Two steps of the 2 x 2 x 2 dp x tp x sp step (SGD momentum 0.9, f32
    momentum), the shards gathered back on every rank, against two JAX
    steps on one device and the global batch: the gradient mean over
    data x seq is the global batch's gradient.  (The JAX shard_map step
    is not the oracle: it applies 4x the mean at 2 x 2 x 2, see the next
    test.)  Losses 1e-5, parameters and momentum 1e-5."""
    want, got = parallel_results
    jloss, jparams, jtrace = want["step"]
    for rank in got["step"]:
        if what == "loss":
            np.testing.assert_allclose(rank[f"{route}/loss"], jloss,
                                       rtol=1e-5, atol=1e-5)
            continue
        ref = jparams if what == "param" else jtrace
        for name, w in ref.items():
            np.testing.assert_allclose(rank[f"{route}/{what}/{name}"],
                                       np.asarray(w), rtol=1e-5, atol=1e-5,
                                       err_msg=name)


def test_jax_dp_tp_sp_step_applies_four_times_the_mean():
    """The reference's finding recorded: JAX ``make_train_step`` on a
    2 x 2 x 2 (data, model, seq) mesh moves every parameter, sharded or
    replicated, by 4x (= data x seq) the single-device step's update on
    the same global batch (plain SGD, lr 0.1, one step); its losses
    agree."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    jcfg, _ = _par_cfgs()
    params, x = _jtree(_params(jcfg, seed=3)), _par_data()
    tokens, labels = jnp.asarray(x["tokens"]), jnp.asarray(x["labels"])
    opt = optax.sgd(PAR_LR)
    loss1, g = jax.value_and_grad(jtfm.loss_fn)(params, tokens, labels, jcfg)
    one = optax.apply_updates(params, opt.update(g, opt.init(params))[0])
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                ("data", "model", "seq"))
    step, specs, opt_specs = jtfm.make_train_step(
        jcfg, opt, mesh, data_axis="data", model_axis="model",
        seq_axis="seq", donate=False)
    put = (lambda tree, spec: jax.device_put(tree, jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), spec,
        is_leaf=lambda v: isinstance(v, P))))
    ds = NamedSharding(mesh, P("data", "seq"))
    eight, _, loss8 = step(put(params, specs), put(opt.init(params),
                                                   opt_specs),
                           jax.device_put(tokens, ds),
                           jax.device_put(labels, ds))
    np.testing.assert_allclose(float(loss8), float(loss1), rtol=1e-5)
    p0, p1, p8 = (_names(t) for t in (params, one, eight))
    for name in p0:
        d1 = np.asarray(p1[name]) - np.asarray(p0[name])
        d8 = np.asarray(p8[name]) - np.asarray(p0[name])
        big = np.abs(d1) > 1e-5
        assert big.any(), name
        np.testing.assert_allclose(np.median(d8[big] / d1[big]), 4.0,
                                   rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("attention", ["flash", "local"])
def test_single_device_routes_raise_under_a_sequence_axis(port_world,
                                                          attention):
    """The reference's ValueError: under a sequence axis the single-device
    routes are refused, never substituted."""
    from horovod_tpu_torch.topology import build_mesh
    _, tcfg = _par_cfgs()
    seq = build_mesh(axes=("seq",), shape=(1,)).axis("seq")
    model = tfm.TransformerLM(tcfg, device="cpu")
    with pytest.raises(ValueError, match="not available with a sequence "
                                         "axis; choose 'ring', 'ring_flash' "
                                         "or 'ulysses'"):
        tfm.forward(model.tree(), torch.zeros((1, 16), dtype=torch.long),
                    tcfg, seq_axis=seq, attention=attention)


@pytest.mark.parametrize("min_t,route", [(None, "ring"),
                                         ("128", "ring_flash")])
def test_auto_under_a_sequence_axis(port_world, monkeypatch, min_t, route):
    """``auto`` under a sequence axis takes ``ring_flash`` once the local
    chunk clears HOROVOD_FLASH_AUTO_MIN_T and tiles by 128 (lowered to
    128 here, as ``tests/test_parallel.py:1091``), ``ring`` otherwise;
    the logits match the JAX single-device forward either way."""
    from horovod_tpu_torch.parallel import sequence as sq
    from horovod_tpu_torch.topology import build_mesh
    if min_t is not None:
        monkeypatch.setenv("HOROVOD_FLASH_AUTO_MIN_T", min_t)
    calls = []
    for name in ("ring_attention", "ring_flash_attention"):
        real = getattr(sq, name)
        monkeypatch.setattr(sq, name, lambda *a, _n=name, _f=real, **kw:
                            calls.append(_n) or _f(*a, **kw))
    jcfg, tcfg = _cfgs(t=128, n_layers=1)
    params = _params(jcfg)
    tokens, _ = _tokens(b=1, t=128)
    seq = build_mesh(axes=("seq",), shape=(1,)).axis("seq")
    got = tfm.forward(_port_model(tcfg, params).tree(),
                      torch.from_numpy(tokens), tcfg, seq_axis=seq,
                      attention="auto")
    assert calls == [route + "_attention"]
    want = np.asarray(jtfm.forward(_jtree(params), jnp.asarray(tokens),
                                   jcfg))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL)


def test_train_step_axes_by_name(port_world):
    """With a model or sequence axis the step's axes are names the mesh
    resolves; a group there, or a mesh with neither a data nor a
    sequence axis, is refused."""
    from horovod_tpu_torch.topology import build_mesh
    _, tcfg = _par_cfgs()
    model = tfm.TransformerLM(tcfg, device="cpu")
    opt = SGD([p for _, p in convert.lm_ordered_parameters(model)], LR, 0.9)
    mesh = build_mesh(axes=("data", "model", "seq"), shape=(1, 1, 1))
    with pytest.raises(TypeError, match="by name"):
        tfm.make_train_step(model, opt, mesh, model_axis=mesh.axis("model"))
    with pytest.raises(ValueError, match="data or a sequence axis"):
        tfm.make_train_step(model, opt, build_mesh(axes=("model",),
                                                   shape=(1,)),
                            model_axis="model")
    step = tfm.make_train_step(model, opt, mesh, model_axis="model",
                               seq_axis="seq", attention="ring_flash")
    x = _par_data()
    loss = step(torch.from_numpy(x["tokens"][:1].astype(np.int64)),
                torch.from_numpy(x["labels"][:1].astype(np.int64)))
    assert np.isfinite(float(loss))
