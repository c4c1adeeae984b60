"""Port parity: the train step of ``curvine_tpu_torch`` (``gpu/model.py``,
``gpu/attention.py``, ``gpu/flash.py``) against the JAX package's
``tpu/model.py`` and ``tpu/ring_attention.dense_attention`` on the CPU,
from one set of numpy inputs; mirrors ``test_chunked_ce_matches_oneshot``,
``test_chunked_ce_grads_match``, ``test_flash_attention_gated_off_cpu``
(``tests/test_tpu.py``) and, on one device, ``test_train_from_cache_e2e``
(``tests/test_train_e2e.py``).

Tolerances (f32 throughout): the two frameworks sum in other orders, so
values agree to a few f32 ulps of the sums' magnitudes, not bit for bit.
Each tolerance below sits 10x or more above the largest difference
measured at these seeds."""

import dataclasses
import math

import numpy as np
import pytest

import jax
import ml_dtypes
import optax

import torch

from curvine_tpu.tpu import model as jm
from curvine_tpu.tpu.ring_attention import dense_attention as jax_dense
from curvine_tpu_torch.gpu import flash, model as tm
from curvine_tpu_torch.gpu.attention import dense_attention
from curvine_tpu_torch.gpu.loader import PosixTrainFeed, write_posix_shards

CPU = torch.device("cpu")
CPUS = jax.devices("cpu")


@pytest.fixture(autouse=True)
def _cpu_default():
    with jax.default_device(CPUS[0]):
        yield


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(4)]


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _grads_of(fn, arrays, do):
    ts = [_t(a, True) for a in arrays]
    out = fn(*ts)
    out.backward(_t(do))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


# ------------------------------------------------------------- attention

@pytest.mark.parametrize("causal", [True, False])
def test_dense_attention_matches_jax(causal):
    q, k, v, do = _qkv((2, 3, 32, 16), 0)
    ref, vjp = jax.vjp(lambda a, b, c: jax_dense(a, b, c, causal=causal),
                       q, k, v)
    ref_grads = vjp(do)
    out, grads = _grads_of(lambda a, b, c: dense_attention(a, b, c, causal),
                           (q, k, v), do)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-6)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("L", [128, 256])
def test_flash_function_on_cpu_matches_jax_dense(L):
    """The flash autograd.Function on CPU tensors (its plain versions)
    against JAX dense_attention and its vjp, head_dim 128."""
    q, k, v, do = _qkv((1, 2, L, flash.HEAD_DIM), L)
    ref, vjp = jax.vjp(lambda a, b, c: jax_dense(a, b, c, causal=True),
                       q, k, v)
    ref_grads = vjp(do)
    out, grads = _grads_of(lambda a, b, c: flash.flash_attention(a, b, c),
                           (q, k, v), do)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-5)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-5)
    # the plain-only Function is the same function
    out_p, grads_p = _grads_of(
        lambda a, b, c: flash.flash_attention_plain(a, b, c), (q, k, v), do)
    np.testing.assert_array_equal(out_p, out)
    for g, r in zip(grads_p, grads):
        np.testing.assert_array_equal(g, r)


def test_flash_plain_residuals():
    """lse is the row's log-sum-exp of the scaled causal scores; di, the
    row sums of P∘dP, is rowsum(o ∘ do); and the plain backward from
    (lse, di) equals autograd through dense attention."""
    q, k, v, do = (torch.from_numpy(a) for a in _qkv((1, 1, 128, 128), 5))
    o, lse = flash.flash_fwd_plain(q, k, v)
    s = (q @ k.transpose(-1, -2)) / math.sqrt(128)
    s = s.masked_fill(torch.ones(128, 128).triu(1).bool(), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6,
                               atol=1e-5)
    di = flash.flash_bwd_di_plain(q, k, v, do, lse)
    torch.testing.assert_close(di, (o * do).sum(-1), rtol=1e-5, atol=1e-5)
    dq, dk, dv = flash.flash_bwd_plain(q, k, v, do, lse, di)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    dense_attention(*ts).backward(do)
    for g, t in zip((dq, dk, dv), ts):
        torch.testing.assert_close(g, t.grad, rtol=1e-4, atol=1e-5)


def test_flash_plain_di_keeps_its_precision_in_bf16():
    """In bf16, di from P∘dP stays at f32 precision where rowsum(o ∘ do)
    from the rounded output carries o's bf16 rounding: near-uniform
    attention, the case where that rounding swamps dS."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((1, 2, 256, 128),
                                             dtype=np.float32)) * 0.01
    k, v, do = (torch.from_numpy(rng.standard_normal(
        (1, 2, 256, 128), dtype=np.float32)) for _ in range(3))
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    o, lse = flash.flash_fwd_plain(qb, kb, vb)
    di = flash.flash_bwd_di_plain(qb, kb, vb, dob, lse).double()
    from_o = (o.double() * dob.double()).sum(-1)
    ref = (dense_attention(*(t.double() for t in (qb, kb, vb)))
           * dob.double()).sum(-1)
    err_pdp = (di - ref).abs().max().item()
    err_o = (from_o - ref).abs().max().item()
    assert err_pdp < 1e-4 and err_pdp * 20 < err_o, (err_pdp, err_o)


def _bf16(shape=(1, 2, 128, 128)):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case,args", [
    ("f32", lambda: [torch.zeros(1, 2, 128, 128)] * 3),
    ("head_dim 64", lambda: [_bf16((1, 2, 128, 64))] * 3),
    ("head_dim 256", lambda: [_bf16((1, 2, 128, 256))] * 3),
    ("L 192", lambda: [_bf16((1, 2, 192, 128))] * 3),
    ("L 0", lambda: [_bf16((1, 2, 0, 128))] * 3),
    ("3-D", lambda: [_bf16((2, 128, 128))] * 3),
    ("shapes differ", lambda: [_bf16(), _bf16(), _bf16((1, 2, 256, 128))]),
    ("not contiguous", lambda: [_bf16((1, 128, 2, 128)).transpose(1, 2)]
     * 3),
    ("B*H too large", lambda: [torch.empty(
        (65536, 1, 128, 128), dtype=torch.bfloat16, device="meta")] * 3),
    ("misaligned", lambda: [torch.empty(
        2 * 128 * 128 + 1, dtype=torch.bfloat16)[1:].view(1, 2, 128, 128)]
     * 3),
])
def test_flash_kernel_args_rejected(case, args):
    """What the CUDA kernels do not take raises before any launch; the
    validation runs on CPU tensors alike."""
    with pytest.raises(ValueError):
        flash.check_kernel_args(*args())


def test_flash_kernel_args_accepted_and_cuda_only():
    q = _bf16()
    flash.check_kernel_args(q, q, q)
    with pytest.raises(ValueError, match="causal"):
        flash.check_kernel_args(q, q, q, False)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash.flash_fwd(q, q, q)
    for bad in (0.0, -0.5, float("inf"), float("nan")):
        with pytest.raises(ValueError, match="sm_scale"):
            flash.flash_fwd(q, q, q, sm_scale=bad)
    lse = torch.zeros(1, 2, 128)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash.flash_bwd_di(q, q, q, q, lse)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash.flash_bwd_dkv(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash.flash_bwd_dq(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="lse"):
        flash.flash_bwd_dq(q, q, q, q, lse.double(), lse)
    assert flash.flash_fwd.launches == flash.flash_bwd_di.launches == \
        flash.flash_bwd_dkv.launches == flash.flash_bwd_dq.launches == 0


# ----------------------------------------------------------------- model

TINY32 = dataclasses.replace(jm.ModelConfig.tiny(), dtype="float32")
HD128 = jm.ModelConfig(vocab=128, d_model=256, n_heads=2, n_layers=2,
                       d_ff=512, max_seq=128, dtype="float32",
                       use_flash_attention=True)


def _port_cfg(cfg: jm.ModelConfig) -> tm.ModelConfig:
    return tm.ModelConfig(**dataclasses.asdict(cfg))


def _jax_params(cfg, seed):
    return jax.tree.map(np.asarray,
                        jm.init_params(jax.random.PRNGKey(seed), cfg))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


def test_model_config_mirrors_jax():
    assert [f.name for f in dataclasses.fields(tm.ModelConfig)] == \
        [f.name for f in dataclasses.fields(jm.ModelConfig)]
    assert dataclasses.asdict(tm.ModelConfig()) == \
        dataclasses.asdict(jm.ModelConfig())
    assert dataclasses.asdict(tm.ModelConfig.tiny()) == \
        dataclasses.asdict(jm.ModelConfig.tiny())


def test_init_params_tree_matches_jax():
    cfg = jm.ModelConfig.tiny()
    ref = jm.init_params(jax.random.PRNGKey(0), cfg)
    got = tm.init_params(torch.Generator().manual_seed(0), _port_cfg(cfg),
                         CPU)
    ref_leaves = jax.tree.leaves(ref)
    got_leaves = tm.leaves(got)
    assert len(got_leaves) == len(ref_leaves)
    for g, r in zip(got_leaves, ref_leaves):
        assert tuple(g.shape) == r.shape and g.dtype == torch.bfloat16
        assert g.requires_grad and g.is_leaf
    assert tm.n_params(got) == sum(r.size for r in ref_leaves)
    # the flagship's count, from shapes alone
    flagship = tm.ModelConfig(vocab=32_000, d_model=2560, n_heads=20,
                              n_layers=12, d_ff=10240, max_seq=1024)
    D, Fd = flagship.d_model, flagship.d_ff
    per_layer = 4 * D * D + 2 * D * Fd + 2 * D
    assert flagship.vocab * D + flagship.max_seq * D + D + \
        flagship.n_layers * per_layer == 1_028_323_840


@pytest.mark.parametrize("name,cfg,shape,flash_on_cpu", [
    ("tiny", TINY32, (2, 33), False),
    ("tiny chunked", dataclasses.replace(TINY32, ce_chunk=24), (2, 33),
     False),
    ("tiny remat", dataclasses.replace(TINY32, remat=True), (2, 17), False),
    ("head_dim 128 via flash", HD128, (2, 128), True),
])
def test_model_matches_jax(monkeypatch, name, cfg, shape, flash_on_cpu):
    """Logits, loss and every parameter's gradient from one JAX tree and
    one batch. With ``flash_on_cpu`` the port's attention goes through
    the flash autograd.Function (its plain versions) while JAX takes
    dense_attention (off the TPU)."""
    pcfg = _port_cfg(cfg)
    if flash_on_cpu:
        calls = []
        real = tm.flash_attention

        def counted(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        monkeypatch.setattr(tm, "_flash_eligible", lambda c, L, d: True)
        monkeypatch.setattr(tm, "flash_attention", counted)
    tree = _jax_params(cfg, 3)
    tokens = _tokens(cfg, shape, 4)
    ref_logits = np.asarray(jax.jit(jm.forward, static_argnums=2)(
        tree, tokens, cfg))
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jm.loss_fn),
                                  static_argnums=2)(tree, tokens, cfg)

    params = tm.params_from_jax(tree, device="cpu")
    tok = torch.from_numpy(tokens)
    with torch.no_grad():
        logits = tm.forward(params, tok, pcfg).numpy()
    np.testing.assert_allclose(logits, ref_logits, rtol=1e-4, atol=1e-4)
    loss = tm.loss_fn(params, tok, pcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    ref_leaves = jax.tree.leaves(ref_grads)
    got = tm.leaves(params)
    assert len(got) == len(ref_leaves)
    for p, r in zip(got, ref_leaves):
        r = np.asarray(r)
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=1e-3,
                                   atol=1e-5 * float(np.abs(r).max()))
    if flash_on_cpu:
        # forward for the logits, forward for the loss: once a layer each
        assert len(calls) == 2 * cfg.n_layers


def test_adamw_step_matches_optax():
    """Two AdamW updates from the same parameters and the same gradients
    (decoupled decay on every leaf, bias correction at steps 1 and 2)."""
    cfg = TINY32
    tree = _jax_params(cfg, 5)
    rng = np.random.default_rng(6)
    grads = [jax.tree.map(lambda a: rng.standard_normal(
        a.shape).astype(np.float32), tree) for _ in range(2)]
    lr = 1e-2
    opt = optax.adamw(lr, weight_decay=0.01)
    state = opt.init(tree)
    ref = tree
    for g in grads:
        upd, state = opt.update(g, state, ref)
        ref = optax.apply_updates(ref, upd)

    params = tm.params_from_jax(tree, device="cpu")
    topt = tm.make_optimizer(params, lr)
    for g in grads:
        for p, gl in zip(tm.leaves(params), jax.tree.leaves(g)):
            p.grad = torch.from_numpy(np.array(gl))
        topt.step()
    # torch scales p by (1 - lr wd) before the Adam step, optax adds the
    # two terms: the same update rounded in another order, a few f32 ulps
    # of |p| <= 1
    for p, r in zip(tm.leaves(params), jax.tree.leaves(ref)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r),
                                   rtol=1e-6, atol=1e-6)


def test_train_step_matches_jax():
    """One whole train step (loss, gradients, AdamW) from one tree: the
    same loss, and parameters that agree after the update.

    A first Adam step moves an entry by lr·g/(|g| + eps), which is
    lr·sign(g) wherever |g| is well above eps. Where the JAX gradient is
    clearly non-zero (above 1e-3 of its leaf's largest), the two steps
    must agree to f32 rounding (1e-6 against entries of |p| <= 1 moved
    by lr = 1e-3): a gradient wired to the wrong leaf or of the wrong
    sign shows there. Only on the rest, whose gradient is near zero (or
    zero, as for the position rows past L) and whose sign the two
    frameworks' sums may not share, may they differ, by up to 2 lr; the
    entries that do are counted and must stay under 0.1% (none at this
    seed)."""
    cfg = TINY32
    lr = 1e-3
    tree = _jax_params(cfg, 7)
    tokens = _tokens(cfg, (2, 32), 8)
    opt = jm.make_optimizer(lr)
    jp, _, jloss = jax.jit(jm.make_train_step(cfg, opt))(
        tree, opt.init(tree), tokens)
    _, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn), static_argnums=2)(
        tree, tokens, cfg)
    params = tm.params_from_jax(tree, device="cpu")
    step = tm.make_train_step(_port_cfg(cfg), tm.make_optimizer(params, lr))
    loss = step(params, torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    tight = banded = moved = 0
    for p, r, p0, g in zip(tm.leaves(params), jax.tree.leaves(jp),
                           jax.tree.leaves(tree), jax.tree.leaves(jgrads)):
        p, r, g = p.detach().numpy(), np.asarray(r), np.abs(np.asarray(g))
        clear = g > 1e-3 * g.max()
        np.testing.assert_allclose(p[clear], r[clear], rtol=0, atol=1e-6)
        np.testing.assert_allclose(p[~clear], r[~clear], rtol=0,
                                   atol=2 * lr + 1e-6)
        tight += int(clear.sum())
        banded += int((np.abs(p - r)[~clear] > 1e-6).sum())
        moved += int((np.abs(p - p0) > lr / 2).sum())
    n = tm.n_params(params)
    assert tight > n // 2
    assert banded <= n // 1000, (banded, n)
    assert moved > n // 2


def test_chunked_ce_matches_oneshot():
    base = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                max_seq=64, dtype="float32")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 64, (3, 33), dtype=np.int32))
    params = tm.init_params(torch.Generator().manual_seed(0),
                            tm.ModelConfig(**base), CPU)
    with torch.no_grad():
        one = tm.loss_fn(params, tokens, tm.ModelConfig(**base))
        for chunk in (16, 25, 96):      # divides, ragged, > total
            chunked = tm.loss_fn(params, tokens,
                                 tm.ModelConfig(**base, ce_chunk=chunk))
            np.testing.assert_allclose(float(one), float(chunked),
                                       rtol=1e-5)


def test_chunked_ce_grads_match():
    base = dict(vocab=32, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                max_seq=32, dtype="float32")
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 32, (2, 17), dtype=np.int32))
    params = tm.init_params(torch.Generator().manual_seed(1),
                            tm.ModelConfig(**base), CPU)

    def grads(cfg):
        for p in tm.leaves(params):
            p.grad = None
        tm.loss_fn(params, tokens, cfg).backward()
        return [p.grad.clone() for p in tm.leaves(params)]

    g1 = grads(tm.ModelConfig(**base))
    g2 = grads(tm.ModelConfig(**base, ce_chunk=8))
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)


def test_flash_attention_gated_off_cpu():
    cfg_d = tm.ModelConfig(vocab=64, d_model=32, n_heads=2, n_layers=1,
                           d_ff=64, max_seq=64, dtype="float32")
    cfg_f = dataclasses.replace(cfg_d, use_flash_attention=True)
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, 64, (2, 64), dtype=np.int32))
    params = tm.init_params(torch.Generator().manual_seed(2), cfg_d, CPU)
    assert not tm._flash_eligible(cfg_f, 64, CPU)
    assert not tm._flash_eligible(
        dataclasses.replace(cfg_f, d_model=256), 128, CPU)
    assert tm._flash_eligible(dataclasses.replace(cfg_f, d_model=256), 128,
                              torch.device("cuda", 0))
    assert not tm._flash_eligible(dataclasses.replace(cfg_f, d_model=256),
                                  96, torch.device("cuda", 0))
    with torch.no_grad():
        np.testing.assert_allclose(tm.forward(params, tokens, cfg_d).numpy(),
                                   tm.forward(params, tokens, cfg_f).numpy(),
                                   rtol=1e-6)


def test_moe_is_not_ported_yet():
    """The name dates from when ``moe_experts > 0`` raised; the MoE FFN is
    ported now (its parity with JAX: tests/test_torch_mesh.py). Such a
    config builds the reference's MoE layer (router, ew1, ew2 in place
    of w1, w2) and runs a finite forward."""
    cfg = dataclasses.replace(tm.ModelConfig.tiny(), moe_experts=2,
                              dtype="float32")
    params = tm.init_params(torch.Generator().manual_seed(0), cfg, CPU)
    ref = jm.init_params(jax.random.PRNGKey(0), jm.ModelConfig(
        **dataclasses.asdict(cfg)))
    for got, want in zip(params["layers"], ref["layers"]):
        assert sorted(got) == sorted(want)
        assert all(tuple(got[k].shape) == want[k].shape for k in got)
    with torch.no_grad():
        logits = tm.forward(params, torch.zeros((2, 16), dtype=torch.int32),
                            cfg)
    assert logits.shape == (2, 16, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


def test_bf16_params_round_trip_bit_for_bit():
    cfg = jm.ModelConfig.tiny()                 # bf16
    tree = _jax_params(cfg, 9)
    assert jax.tree.leaves(tree)[0].dtype == ml_dtypes.bfloat16
    params = tm.params_from_jax(tree, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in tm.leaves(params))
    back = tm.params_to_numpy(params)
    for b, r in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert b.dtype == np.uint16
        np.testing.assert_array_equal(b, r.view(np.uint16))
    # and the values, as floats
    np.testing.assert_array_equal(
        params["embed"].detach().float().numpy(),
        np.asarray(tree["embed"]).astype(np.float32))


def test_bf16_forward_close_to_jax():
    """The bf16 path (the flagship's dtype) against JAX at bf16: both
    round at their own places, so logits agree to bf16's precision."""
    cfg = jm.ModelConfig.tiny()
    tree = _jax_params(cfg, 10)
    tokens = _tokens(cfg, (2, 32), 11)
    ref = np.asarray(jm.forward(tree, tokens, cfg))
    with torch.no_grad():
        got = tm.forward(tm.params_from_jax(tree, device="cpu"), torch.from_numpy(tokens),
                         _port_cfg(cfg)).numpy()
    scale = float(np.abs(ref).max())
    assert np.abs(got - ref).max() <= 0.05 * scale
    assert float(np.mean(np.abs(got - ref))) <= 0.01 * scale


async def test_train_from_cache_e2e_one_device(tmp_path):
    """A repeating 16-token pattern written as shards, fed through
    PosixTrainFeed (CPU device) into the port's train step: the loss falls
    below half its first value."""
    cfg = tm.ModelConfig(vocab=128, d_model=64, n_heads=4, n_layers=2,
                         d_ff=128, max_seq=64, dtype="float32")
    tokens = np.tile(np.arange(16, dtype=np.int32), 4096 // 16 * 8)
    root = str(tmp_path / "tok")
    write_posix_shards(root, tokens, shard_tokens=4096)
    params = tm.init_params(torch.Generator().manual_seed(0), cfg, CPU)
    step = tm.make_train_step(cfg, tm.make_optimizer(params, 1e-2))
    losses = []
    for _ in range(4):
        async for batch in PosixTrainFeed(root, batch=8, seq_len=64,
                                          device=CPU):
            assert batch.shape == (8, 64) and batch.dtype == torch.int32
            losses.append(float(step(params, batch)))
    assert len(losses) == 4 * tokens.size // (8 * 64)
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
