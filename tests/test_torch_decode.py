"""The port's KV-cache decode and greedy ``generate`` against the JAX
package's, on the CPU.

The same seeded parameters (numpy ``default_rng``, crossed with
``convert.lm_params_to_torch``) and tokens go through
``horovod_tpu.models.transformer.decode_step``/``generate`` (jitted) and
the port's.  Config: vocab 64, d_model 32, 4 heads, 2 layers, d_ff 64,
max_seq 16, a cache of 8 positions stepped through positions 0-7, so the
mask cuts the cache at every step but the last.  Tolerances: f32 logits
and caches 1e-5; bf16 logits row by row and each cache as a whole,
``||a - b|| / ||b||`` 2e-2 (XLA computes the bf16 head matmul into f32
and fuses elementwise bf16 chains that eager PyTorch rounds op by op:
worst row 0.0086 here); generate
token for token; decode==forward 2e-4, the reference's
(``tests/test_models.py:186``); decode under 2-way tensor parallelism on
2 gloo ranks against the JAX single-device decode 2e-4
(``tests/test_parallel.py:534``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from horovod_tpu.models import transformer as jtfm
import horovod_tpu_torch as thvd
from horovod_tpu_torch import benchmark
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as tfm
from torch_support import start_port_job

TOL = 1e-5
BF16_TOL = 2e-2
ORACLE_TOL = 2e-4
MAX_LEN = 8

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(dtype="float32", n_layers=2):
    kw = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=n_layers,
              d_ff=64, max_seq=16)
    return (jtfm.TransformerConfig(dtype=_JDT[dtype], **kw),
            tfm.TransformerConfig(dtype=_TDT[dtype], **kw))


def _params(seed=0, n_layers=2):
    """Seeded f32 parameters in the JAX tree layout (numpy), RMSNorm
    scales away from one."""
    rng = np.random.default_rng(seed)
    d, f = 32, 64

    def dense(shape, scale=None):
        return (rng.standard_normal(shape) * (scale or shape[0] ** -0.5)
                ).astype(np.float32)

    def norm():
        return (1.0 + 0.2 * rng.standard_normal(d)).astype(np.float32)

    return {
        "embed": dense((64, d), 0.5), "pos": dense((16, d), 0.5),
        "ln_f_scale": norm(),
        "layers": [{"ln1_scale": norm(), "ln2_scale": norm(),
                    "wq": dense((d, d)), "wk": dense((d, d)),
                    "wv": dense((d, d)), "wo": dense((d, d)),
                    "w1": dense((d, f)), "w2": dense((f, d))}
                   for _ in range(n_layers)],
    }


def _tokens(b=2, t=MAX_LEN, seed=1):
    return np.random.default_rng(seed).integers(0, 64, (b, t))


def _port_tree(tcfg, params):
    model = tfm.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(convert.lm_params_to_torch(params))
    return model.tree()


def _jax_decode(dtype, params, tokens):
    """Logits of every step and the caches after the last, JAX."""
    jcfg, _ = _cfgs(dtype)
    step = jax.jit(jtfm.decode_step, static_argnums=(4,))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    cache = jtfm.init_kv_cache(jcfg, tokens.shape[0], MAX_LEN)
    logits = []
    for pos in range(tokens.shape[1]):
        lg, cache = step(p, jnp.asarray(tokens[:, pos], jnp.int32), cache,
                         pos, jcfg)
        logits.append(np.asarray(lg))
    return np.stack(logits, 1), [{k: np.asarray(c[k], np.float32)
                                  for k in c} for c in cache]


@pytest.fixture(scope="module")
def jax_decode():
    params, tokens = _params(), _tokens()
    return {dt: _jax_decode(dt, params, tokens)
            for dt in ("float32", "bfloat16")}


def _port_decode(dtype, params, tokens):
    _, tcfg = _cfgs(dtype)
    tree = _port_tree(tcfg, params)
    cache = tfm.init_kv_cache(tcfg, tokens.shape[0], MAX_LEN, device="cpu")
    logits = []
    with torch.no_grad():
        for pos in range(tokens.shape[1]):
            lg, cache = tfm.decode_step(tree, torch.from_numpy(
                tokens[:, pos]), cache, pos, tcfg)
            logits.append(lg.numpy())
    return np.stack(logits, 1), [{k: c[k].float().numpy() for k in c}
                                 for c in cache]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(jax_decode, dtype):
    """Every position's logits (the mask cutting the cache at positions
    0-6) and the caches after position 7, in the cache's dtype."""
    want_logits, want_cache = jax_decode[dtype]
    got_logits, got_cache = _port_decode(dtype, _params(), _tokens())
    if dtype == "float32":
        np.testing.assert_allclose(got_logits, want_logits, rtol=TOL,
                                   atol=TOL)
    else:
        rows = (np.linalg.norm(got_logits - want_logits, axis=-1) /
                np.linalg.norm(want_logits, axis=-1))
        assert rows.max() <= BF16_TOL, rows.max()
    for layer, (g, w) in enumerate(zip(got_cache, want_cache)):
        for k in ("k", "v"):
            if dtype == "float32":
                np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL,
                                           err_msg=f"{layer}.{k}")
            else:
                rel = np.linalg.norm(g[k] - w[k]) / np.linalg.norm(w[k])
                assert rel <= BF16_TOL, (layer, k, rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_cache_keeps_its_dtype(dtype):
    """The defensive cast of the reference's r4 fix: the cache stays
    ``cfg.dtype`` and is written in place (the returned cache is the
    one passed in)."""
    _, tcfg = _cfgs(dtype)
    tree = _port_tree(tcfg, _params())
    cache = tfm.init_kv_cache(tcfg, 2, MAX_LEN, device="cpu")
    with torch.no_grad():
        _, out = tfm.decode_step(tree, torch.tensor([5, 9]), cache, 3, tcfg)
    assert out is cache
    for c in cache:
        assert c["k"].dtype == c["v"].dtype == _TDT[dtype]
        assert c["k"].shape == (2, MAX_LEN, 4, 8)
        assert c["k"][:, 3].abs().sum() > 0 and c["k"][:, 4:].abs().sum() == 0


@pytest.mark.parametrize("pos", [MAX_LEN, MAX_LEN + 5, 20])
def test_decode_step_past_the_end_clamps_as_jax(pos):
    """A position past the cache (and, at 20, past the positional table)
    reads and writes the last row, as ``lax.dynamic_slice`` and
    ``dynamic_update_slice`` clamp."""
    jcfg, tcfg = _cfgs()
    params = _params()
    tok = np.array([5, 9])
    p = jax.tree_util.tree_map(jnp.asarray, params)
    want, wcache = jtfm.decode_step(p, jnp.asarray(tok, jnp.int32),
                                    jtfm.init_kv_cache(jcfg, 2, MAX_LEN),
                                    pos, jcfg)
    cache = tfm.init_kv_cache(tcfg, 2, MAX_LEN, device="cpu")
    with torch.no_grad():
        got, cache = tfm.decode_step(_port_tree(tcfg, params),
                                     torch.from_numpy(tok), cache, pos, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(cache[0]["k"].numpy(),
                               np.asarray(wcache[0]["k"]), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("attention", ["local", "flash"])
def test_decode_matches_forward(attention):
    """The reference's oracle (``tests/test_models.py:186``): decode_step
    reproduces the training forward's logits position by position."""
    _, tcfg = _cfgs()
    tree = _port_tree(tcfg, _params())
    tokens = torch.from_numpy(_tokens(t=16, seed=2))
    with torch.no_grad():
        oracle = tfm.forward(tree, tokens, tcfg, attention=attention)
        cache = tfm.init_kv_cache(tcfg, 2, 16, device="cpu")
        outs = []
        for pos in range(16):
            logits, cache = tfm.decode_step(tree, tokens[:, pos], cache, pos,
                                            tcfg)
            outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), oracle.numpy(),
                               rtol=ORACLE_TOL, atol=ORACLE_TOL)


@pytest.fixture(scope="module")
def jax_generate():
    jcfg, _ = _cfgs()
    p = jax.tree_util.tree_map(jnp.asarray, _params())
    prompt = _tokens(t=3, seed=4)
    out = {}
    for total in (3, 12):
        out[total] = np.asarray(jax.jit(lambda p_, t_: jtfm.generate(
            p_, t_, total, jcfg))(p, jnp.asarray(prompt, jnp.int32)))
    return prompt, out


@pytest.mark.parametrize("total", [3, 12])
def test_generate_matches_jax(jax_generate, total):
    """Token for token: the teacher-forced prompt, then greedy argmax."""
    prompt, want = jax_generate
    _, tcfg = _cfgs()
    got = tfm.generate(_port_tree(tcfg, _params()), torch.from_numpy(prompt),
                       total, tcfg)
    assert got.shape == (2, total) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want[total])
    np.testing.assert_array_equal(got[:, :3].numpy(), prompt)


def test_generate_is_step_by_step_argmax():
    """The reference's ``tests/test_models.py:214`` oracle: generate equals
    a manual loop of decode_step and argmax, teacher-forced inside the
    prompt."""
    _, tcfg = _cfgs()
    tree = _port_tree(tcfg, _params(seed=3))
    prompt = torch.tensor([[3, 7, 1]])
    out = tfm.generate(tree, prompt, 8, tcfg)
    cache = tfm.init_kv_cache(tcfg, 1, 8, device="cpu")
    tok, seq = prompt[:, 0], [3]
    with torch.no_grad():
        for pos in range(7):
            logits, cache = tfm.decode_step(tree, tok, cache, pos, tcfg)
            tok = (prompt[:, pos + 1] if pos + 1 < 3
                   else logits.argmax(-1))
            seq.append(int(tok[0]))
    assert seq == out[0].tolist()


@pytest.mark.parametrize("prompt_len,total", [(3, 17), (9, 8)])
def test_generate_errors_match_jax(prompt_len, total):
    """Both of the reference's ValueErrors, word for word."""
    jcfg, tcfg = _cfgs()
    prompt = _tokens(b=1, t=prompt_len)
    with pytest.raises(ValueError) as want:
        jtfm.generate(jax.tree_util.tree_map(jnp.asarray, _params()),
                      jnp.asarray(prompt, jnp.int32), total, jcfg)
    with pytest.raises(ValueError, match=re.escape(str(want.value)) + "$"):
        tfm.generate(_port_tree(tcfg, _params()), torch.from_numpy(prompt),
                     total, tcfg)


class _Casts(TorchDispatchMode):
    """Counts the casts of the parameters' own storage (not of activations
    computed from them)."""

    def __init__(self, params):
        super().__init__()
        self.ptrs = {p.data_ptr() for p in params}
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func is torch.ops.aten._to_copy.default and
                args[0].data_ptr() in self.ptrs):
            self.n += 1
        return func(*args, **kwargs)


def test_generate_casts_the_weights_once_per_call():
    """The f32 weights are cast to the compute dtype once per call, as the
    reference's scanned program casts them, not once per token: a call
    casts each of the 8 leaves of a layer, ``ln_f_scale`` and the tied
    head once, whatever its length, and its tokens equal a step-by-step
    decode_step's, which casts every step."""
    _, tcfg = _cfgs("bfloat16")
    tree = _port_tree(tcfg, _params())
    leaves = [tree["embed"], tree["ln_f_scale"]] + [
        w for layer in tree["layers"] for w in layer.values()]
    prompt = torch.from_numpy(_tokens(b=2, t=2))
    counts, outs = {}, {}
    for total in (4, 12):
        with _Casts(leaves) as casts:
            outs[total] = tfm.generate(tree, prompt, total, tcfg)
        counts[total] = casts.n
    assert counts[4] == counts[12] == 2 * 8 + 2, counts
    cache = tfm.init_kv_cache(tcfg, 2, 12, device="cpu")
    tok, seq = prompt[:, 0], [prompt[:, 0]]
    with torch.no_grad():
        for pos in range(11):
            logits, cache = tfm.decode_step(tree, tok, cache, pos, tcfg)
            tok = prompt[:, pos + 1] if pos + 1 < 2 else logits.argmax(-1)
            seq.append(tok)
    assert torch.equal(outs[12], torch.stack(seq, 1))


TP_JOB = r'''
import os, pickle, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import transformer as tfm
from horovod_tpu_torch.topology import build_mesh

out = sys.argv[1]
hvd.init(device="cpu")
with open(os.path.join(out, "params.pkl"), "rb") as fh:
    params = pickle.load(fh)
tok = torch.from_numpy(np.load(os.path.join(out, "tok.npy")))
prompt = torch.from_numpy(np.load(os.path.join(out, "prompt.npy")))
cfg = tfm.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                            n_layers=2, d_ff=64, max_seq=16,
                            dtype=torch.float32)
mesh = build_mesh(axes=("model",), shape=(2,))
model = tfm.TransformerLM(cfg, device="cpu", model_shards=2)
model.load_state_dict(convert.lm_params_to_shards(params, mesh, "model"))
cache = tfm.init_kv_cache(cfg, 2, 4, model_axis_size=2, device="cpu")
with torch.no_grad():
    logits, cache = tfm.decode_step(model.tree(), tok, cache, 0, cfg,
                                    model_axis=mesh.axis("model"))
gen = tfm.generate(model.tree(), prompt, 10, cfg,
                   model_axis=mesh.axis("model"))
np.savez(os.path.join(out, f"rank{hvd.rank()}.npz"), logits=logits.numpy(),
         k=cache[0]["k"].numpy(), gen=gen.numpy())
hvd.shutdown()
'''


@pytest.fixture(scope="module")
def tp_results(tmp_path_factory):
    import pickle
    out = tmp_path_factory.mktemp("decode_tp")
    params = _params(n_layers=2)
    with open(out / "params.pkl", "wb") as fh:
        pickle.dump(params, fh)
    tok, prompt = np.array([5, 9]), _tokens(t=3, seed=6)
    np.save(out / "tok.npy", tok)
    np.save(out / "prompt.npy", prompt)
    finish = start_port_job(TP_JOB, str(out), np_=2, timeout=300,
                            env={"OMP_NUM_THREADS": "1"})
    jcfg, _ = _cfgs()
    p = jax.tree_util.tree_map(jnp.asarray, params)
    logits, cache = jtfm.decode_step(p, jnp.asarray(tok, jnp.int32),
                                     jtfm.init_kv_cache(jcfg, 2, 4), 0, jcfg)
    gen = jax.jit(lambda p_, t_: jtfm.generate(p_, t_, 10, jcfg))(
        p, jnp.asarray(prompt, jnp.int32))
    ranks, _ = finish()
    return (np.asarray(logits), np.asarray(cache[0]["k"]),
            np.asarray(gen)), ranks


def test_decode_under_tp_matches_single_device_jax(tp_results):
    """2-way Megatron shards on 2 gloo ranks: every rank's logits are the
    single-device decode's, and its cache holds its own heads."""
    (want, want_k, _), ranks = tp_results
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["logits"], want, rtol=ORACLE_TOL,
                                   atol=ORACLE_TOL)
        np.testing.assert_allclose(got["k"], want_k[:, :, 2 * r:2 * r + 2],
                                   rtol=ORACLE_TOL, atol=ORACLE_TOL)


def test_generate_under_tp_matches_single_device_jax(tp_results):
    (_, _, want), ranks = tp_results
    for got in ranks:
        np.testing.assert_array_equal(got["gen"], want)


def test_decode_benchmark_plumbing_on_cpu():
    """run_decode_benchmark end to end on a tiny config (reference
    ``tests/test_models.py:80``): the reference's keys, tokens per second
    over the new tokens, and the same ValueError for a prompt that leaves
    nothing to decode."""
    res = benchmark.run_decode_benchmark(
        d_model=32, n_layers=2, n_heads=2, vocab_size=64, batch_size=2,
        prompt_len=4, total_len=16, num_iters=1, device="cpu",
        verbose=False)
    assert {"d_model", "n_layers", "batch_size", "total_len",
            "decode_tok_sec", "ms_per_step"} <= set(res)
    assert res["decode_tok_sec"] > 0 and res["ms_per_step"] > 0
    assert res["platform"] == "cpu" and res["max_memory_allocated"] is None
    with pytest.raises(ValueError, match=re.escape(
            "prompt_len (16) must be < total_len (16) to decode anything")):
        benchmark.run_decode_benchmark(prompt_len=16, total_len=16,
                                       device="cpu")


@pytest.fixture()
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    yield


def test_decode_entry_points_without_gpu_or_device_raise(no_gpu):
    """No card and no device: the entry points raise instead of falling
    back to the CPU."""
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.init_kv_cache(tcfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        benchmark.run_decode_benchmark(d_model=32, n_layers=1, n_heads=2,
                                       vocab_size=64, batch_size=1,
                                       prompt_len=2, total_len=4)
    assert not thvd.is_initialized()
