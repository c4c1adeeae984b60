"""Port parity: pipeline parallelism, ring attention and the ``seq`` axis
of ``curvine_tpu_torch`` (``gpu/pipeline.py``, ``gpu/attention.py``'s
ring, ``gpu/mesh.py::ppermute``, ``gpu/model.py`` on a mesh with
``seq``) against the JAX package's on four CPU devices, from the same
inputs.

Mirrors ``test_ring_attention_matches_dense`` (tests/test_tpu.py:26: q,
k, v [2, 4, 64, 16] f32 on a ``("seq",)`` mesh of 4, causal and not,
within 2e-5 of dense attention; here also the gradients of q, k and v
against ``jax.grad`` of JAX's ring), ``test_pipeline_parallel_matches_
sequential`` (:299: the 4-layer f32 model on ``("pp",)`` of 4, 2
microbatches, logits within 1e-4 of the sequential forward; the
reference asserts one gradient leaf non-zero, here every leaf is held to
JAX's ``jax.grad(pipeline_loss)``), and the first pass of
``dryrun_multichip`` (__graft_entry__.py:140-176: its config on a
``(2, 1, 2)`` data x model x seq mesh with ring attention, one jitted
train step; here with ring attention, without it, and with ``remat``).
One spawn of four gloo ranks serves every check; the ranks meet through
a file store under ``tmp_path``, each takes one intra-op thread, and the
spawn is killed after ``SPAWN_TIMEOUT_S``. JAX runs in the test's
process meanwhile.

Tolerances are f32's: the two frameworks sum in other orders. Each bound
below sits 10x or more above the largest difference measured at these
seeds (in each test's docstring)."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding

from curvine_tpu.tpu import model as jm
from curvine_tpu.tpu import pipeline as jp
from curvine_tpu.tpu import ring_attention as jr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPUS = jax.devices("cpu")
SPAWN_TIMEOUT_S = 240

# test_tpu.py:299's config and tokens
PIPE_CFG = jm.ModelConfig(vocab=64, d_model=32, n_heads=2, n_layers=4,
                          d_ff=64, max_seq=32, dtype="float32")
PIPE_TOKENS = np.random.default_rng(0).integers(0, 64, (4, 16)).astype(
    np.int32)
# __graft_entry__.py:156-166's config and tokens at data 2, seq 2 (the
# fixture sets the first token of the second half, see _boundary_tokens)
DRY_CFG = jm.ModelConfig(vocab=512, d_model=64, n_heads=4, n_layers=2,
                         d_ff=128, max_seq=64, dtype="float32",
                         use_ring_attention=True)
DRY_TOKENS = np.random.default_rng(1).integers(0, 512, (4, 64)).astype(
    np.int32)
DRY_CASES = {
    # name: (the port's config, JAX's config); the reference's remat
    # cannot take its mesh (ROADMAP C), so its side runs without remat,
    # which changes no value
    "ring": (DRY_CFG, DRY_CFG),
    "gather": (dataclasses.replace(DRY_CFG, use_ring_attention=False),
               dataclasses.replace(DRY_CFG, use_ring_attention=False)),
    "ring_remat": (dataclasses.replace(DRY_CFG, remat=True), DRY_CFG),
}
DRY_SHAPE = (2, 1, 2)

# One rank of the port: argv is (rank, world, store, work dir). Reads the
# inputs from the work dir; writes its results to rank<k>.json, rank 0
# also its gathered arrays to out.npz.
_RANK = r"""
import dataclasses, json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from torch.distributed.tensor import distribute_tensor
from curvine_tpu_torch.gpu import model as tm, multihost, pipeline as pl
from curvine_tpu_torch.gpu.attention import ring_attention_sharded, ring_spec
from curvine_tpu_torch.gpu.ingest import put_sharded
from curvine_tpu_torch.gpu.mesh import make_mesh, placements, ppermute

rank, world, store, work = (int(sys.argv[1]), int(sys.argv[2]),
                            sys.argv[3], sys.argv[4])
multihost.initialize(f"file://{store}", world, rank, cpu=True)
out, save = {}, {}

def tree_of(data, n_layers):
    tree = {k: data[k] for k in ("embed", "pos", "ln_f")}
    tree["layers"] = [{k.split(".", 1)[1]: data[k] for k in data.files
                       if k.startswith(f"{i}.")} for i in range(n_layers)]
    return tree

# ppermute: a shift of 1 on four ranks and on a one-rank axis
pp = make_mesh(axis_names=("pp",), shape=(4,))
x = torch.full((3,), float(rank), requires_grad=True)
y = ppermute(x, pp, "pp")
y.backward(torch.full((3,), 10.0 * rank))
out["shift4"] = {"y": y.tolist(), "grad": x.grad.tolist()}
two = make_mesh(axis_names=("a", "b"), shape=(4, 1))
x = torch.full((3,), float(rank), requires_grad=True)
y = ppermute(x, two, "b")
y.backward(torch.full((3,), 10.0 * rank))
out["shift1"] = {"y": y.tolist(), "grad": x.grad.tolist(),
                 "copy": y.data_ptr() != x.data_ptr()}

# ring attention on ("seq",) of 4, forward and backward
seq = make_mesh(axis_names=("seq",), shape=(4,))
d = np.load(f"{work}/ring.npz")
lay = placements(seq, ring_spec(seq))
out["ring_spec"] = [repr(p) for p in lay]
for causal in (True, False):
    q, k, v = (distribute_tensor(torch.from_numpy(d[n]), seq, lay)
               .requires_grad_(True) for n in "qkv")
    o = ring_attention_sharded(q, k, v, seq, causal=causal)
    o.backward(distribute_tensor(torch.from_numpy(d["do"]), seq, lay))
    full = [t.full_tensor().detach().numpy()
            for t in (o, q.grad, k.grad, v.grad)]
    out[f"ring_{causal}_local"] = list(o.to_local().shape)
    for name, a in zip(("o", "dq", "dk", "dv"), full):
        save[f"ring_{causal}_{name}"] = a

# pipeline on ("pp",) of 4, 2 microbatches
d = np.load(f"{work}/pipe.npz")
cfg = tm.ModelConfig(**json.load(open(f"{work}/pipe.json")))
params = tm.params_from_jax(tree_of(d, cfg.n_layers), device="cpu")
st = pl.shard_stacked(pl.stack_layers(params), pp)
tok = torch.from_numpy(d["tokens"])
with torch.no_grad():
    save["pipe_logits"] = pl.pipeline_forward(st, tok, cfg, pp, 2).numpy()
loss = pl.pipeline_loss(st, tok, cfg, pp, microbatches=2)
loss.backward()
out["pipe_loss"] = float(loss)
out["pipe_layer_placements"] = sorted({repr(v.placements)
                                       for v in st["layers"].values()})
for i, p in enumerate(tm.leaves(st)):
    save[f"pipe_grad_{i}"] = p.grad.full_tensor().numpy()

# dryrun_multichip's first pass on (2, 1, 2) data x model x seq
cases = json.load(open(f"{work}/dry.json"))
d = np.load(f"{work}/dry.npz")
mesh = make_mesh(axis_names=("data", "model", "seq"), shape=(2, 1, 2))
di, si = mesh.get_local_rank("data"), mesh.get_local_rank("seq")
B, L = d["tokens"].shape
local = d["tokens"][di * B // 2:(di + 1) * B // 2,
                    si * L // 2:(si + 1) * L // 2]
for name, c in cases.items():
    cfg = tm.ModelConfig(**c)
    params = tm.shard_params(tm.params_from_jax(tree_of(d, cfg.n_layers),
                                                device="cpu"), mesh)
    tok = put_sharded(local, mesh, tm.batch_spec(mesh))
    loss0 = tm.loss_fn(params, tok, cfg, mesh)
    loss0.backward()
    grads = [p.grad.redistribute(p.device_mesh, p.placements).full_tensor()
             for p in tm.leaves(params)]
    step = tm.make_train_step(cfg, tm.make_optimizer(params), mesh)
    loss = float(step(params, tok))
    gathered = [p.full_tensor().detach().numpy() for p in tm.leaves(params)]
    x, targets = tm._next_tokens(torch.zeros(local.shape + (1,)),
                                 tok.to_local(), mesh)
    out[name] = {"loss0": float(loss0), "loss": loss,
                 "tok_local": list(tok.to_local().shape),
                 "tok_placements": [repr(p) for p in tok.placements],
                 "coords": [di, si], "rows": list(x.shape[:2]),
                 "targets": targets.tolist()}
    for i, (g, p) in enumerate(zip(grads, gathered)):
        save[f"{name}_grad_{i}"] = g.detach().numpy()
        save[f"{name}_leaf_{i}"] = p
json.dump(out, open(f"{work}/rank{rank}.json", "w"))
if rank == 0:
    np.savez(f"{work}/out.npz", **save)
multihost.shutdown()
print("rank", rank, "ok", flush=True)
"""


def _flat(tree) -> dict:
    """A JAX parameter tree as ``{name: array}``: ``embed``, ``pos``,
    ``ln_f`` and ``<layer>.<key>``."""
    flat = {k: np.asarray(tree[k]) for k in ("embed", "pos", "ln_f")}
    for i, layer in enumerate(tree["layers"]):
        flat.update({f"{i}.{k}": np.asarray(v) for k, v in layer.items()})
    return flat


def _ring_inputs():
    rng = np.random.default_rng(0)
    return {n: rng.standard_normal((2, 4, 64, 16)).astype(np.float32)
            for n in ("q", "k", "v", "do")}


def _jax_ring(inputs):
    """JAX's ring on four CPU devices: (o, dq, dk, dv) per causal flag,
    ``jax.grad`` of sum(o * do)."""
    mesh = Mesh(np.array(CPUS[:4]), ("seq",))
    q, k, v, do = (jnp.asarray(inputs[n]) for n in ("q", "k", "v", "do"))
    out = {}
    with jax.default_matmul_precision("highest"):
        for causal in (True, False):
            def f(q, k, v, do):
                o, vjp = jax.vjp(lambda q, k, v: jr.ring_attention_sharded(
                    q, k, v, mesh, causal=causal), q, k, v)
                return (o,) + vjp(do)
            out[causal] = [np.asarray(x) for x in jax.jit(f)(q, k, v, do)]
    return out


def _jax_pipe(tree):
    """JAX's sequential forward, its pipeline's forward on ``("pp",)`` of
    four CPU devices, and ``jax.grad`` of its pipeline loss (leaves in
    ``jax.tree.leaves`` order)."""
    mesh = Mesh(np.array(CPUS[:4]), ("pp",))
    tokens = jnp.asarray(PIPE_TOKENS)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p: jm.forward(p, tokens, PIPE_CFG))(tree)
        stacked = jp.shard_stacked(jp.stack_layers(tree), mesh)
        out = jax.jit(lambda p: jp.pipeline_forward(
            p, tokens, PIPE_CFG, mesh, microbatches=2))(stacked)
        g = jax.jit(jax.grad(lambda p: jp.pipeline_loss(
            p, tokens, PIPE_CFG, mesh)))(stacked)
    return {"forward": np.asarray(ref), "pipeline": np.asarray(out),
            "grads": [np.asarray(x) for x in jax.tree.leaves(g)]}


def _boundary_tokens(tree) -> np.ndarray:
    """The dryrun's tokens with the first token of the second half (the
    'seq' boundary at data 2, seq 2) set, row by row, to the token that
    JAX's model finds least likely after the first half: the boundary
    pair's loss then stands far above the mean, so a loss that drops it
    or weights the halves wrongly is far from the right one."""
    tokens = DRY_TOKENS.copy()
    half = tokens.shape[1] // 2
    logits = jax.jit(lambda p, t: jm.forward(p, t, DRY_CFG))(tree, tokens)
    tokens[:, half] = np.argmin(np.asarray(logits)[:, half - 1], axis=-1)
    return tokens


def _jax_dry(tree, cfg, tokens):
    """JAX's jitted loss, gradients and one train step (optax AdamW at
    its default lr) on a (2, 1, 2) data x model x seq mesh of four CPU
    devices; leaves in ``jax.tree.leaves`` order."""
    mesh = Mesh(np.array(CPUS[:4]).reshape(DRY_SHAPE),
                ("data", "model", "seq"))
    params = jm.shard_params(tree, mesh)
    tok = jax.device_put(tokens, NamedSharding(mesh, jm.batch_spec(mesh)))
    loss0, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jm.loss_fn(p, t, cfg, mesh)))(params, tok)
    opt = jm.make_optimizer()
    step = jax.jit(jm.make_train_step(cfg, opt, mesh))
    params, _, loss = step(params, opt.init(params), tok)
    # the per-position losses, for the halo and denominator checks
    logits = jax.jit(lambda p, t: jm.forward(p, t, cfg, mesh))(
        jm.shard_params(tree, mesh), tok)
    logp = jax.nn.log_softmax(np.asarray(logits)[:, :-1], axis=-1)
    nll = -np.take_along_axis(np.asarray(logp), tokens[:, 1:, None],
                              axis=-1)[..., 0]
    return {"loss0": float(loss0), "loss": float(loss),
            "grads": [np.asarray(g) for g in jax.tree.leaves(grads)],
            "leaves": [np.asarray(x) for x in jax.tree.leaves(params)],
            "nll": nll}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the four ranks, run JAX's side meanwhile, then collect the
    ranks' results."""
    work = tmp_path_factory.mktemp("pipeline_ring")
    ring_in = _ring_inputs()
    np.savez(work / "ring.npz", **ring_in)
    with jax.default_device(CPUS[0]):
        pipe_tree = jax.tree.map(np.asarray, jm.init_params(
            jax.random.PRNGKey(0), PIPE_CFG))
        dry_tree = jax.tree.map(np.asarray, jm.init_params(
            jax.random.PRNGKey(0), DRY_CFG))
        dry_tokens = _boundary_tokens(dry_tree)
    np.savez(work / "pipe.npz", tokens=PIPE_TOKENS, **_flat(pipe_tree))
    (work / "pipe.json").write_text(json.dumps(dataclasses.asdict(PIPE_CFG)))
    np.savez(work / "dry.npz", tokens=dry_tokens, **_flat(dry_tree))
    (work / "dry.json").write_text(json.dumps(
        {name: dataclasses.asdict(c) for name, (c, _) in DRY_CASES.items()}))
    script = work / "rank.py"
    script.write_text(_RANK)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), "4", str(work / "store"),
         str(work)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True) for r in range(4)]
    try:
        with jax.default_device(CPUS[0]):
            jax_runs = {"attn": _jax_ring(ring_in),
                        "pipe": _jax_pipe(pipe_tree)}
            for name, (_, jcfg) in DRY_CASES.items():
                same = [n for n, (_, c) in DRY_CASES.items() if c == jcfg]
                jax_runs[name] = jax_runs[same[0]] if same[0] in jax_runs \
                    else _jax_dry(dry_tree, jcfg, dry_tokens)
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=SPAWN_TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r} ok" in out, \
            f"rank {r} failed:\n{out[-3000:]}"
    return {"jax": jax_runs, "ring_in": ring_in, "dry_tokens": dry_tokens,
            "ranks": [json.loads((work / f"rank{r}.json").read_text())
                      for r in range(4)],
            "port": dict(np.load(work / "out.npz"))}


def test_ppermute_shifts_and_its_gradient_shifts_back(runs):
    """A shift of 1 on four ranks: rank r receives rank r-1's tensor,
    and its gradient (10·k from rank k) comes back from rank r+1. On an
    axis of one rank it is a copy (another tensor), with the gradient
    unchanged."""
    for r, got in enumerate(runs["ranks"]):
        assert got["shift4"]["y"] == [float((r - 1) % 4)] * 3
        assert got["shift4"]["grad"] == [10.0 * ((r + 1) % 4)] * 3
        assert got["shift1"]["y"] == [float(r)] * 3
        assert got["shift1"]["grad"] == [10.0 * r] * 3
        assert got["shift1"]["copy"]


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_dense(runs, causal):
    """test_tpu.py:26 on four gloo ranks: the port's ring within 2e-5 of
    the port's dense attention (measured 4.8e-7) and of JAX's ring
    (measured 4.8e-7); the q, k, v gradients through ``ppermute`` within
    2e-5 of ``jax.grad`` of JAX's ring (measured 7.2e-7). Each rank holds
    a quarter of the sequence."""
    import torch
    from curvine_tpu_torch.gpu.attention import dense_attention
    port = runs["port"]
    q, k, v = (torch.from_numpy(runs["ring_in"][n]) for n in "qkv")
    dense = dense_attention(q, k, v, causal=causal).numpy()
    o = port[f"ring_{causal}_o"]
    assert np.abs(o - dense).max() < 2e-5
    ref = runs["jax"]["attn"][causal]
    assert np.abs(o - ref[0]).max() < 2e-5
    for name, want in zip(("dq", "dk", "dv"), ref[1:]):
        got = port[f"ring_{causal}_{name}"]
        assert np.abs(got - want).max() < 2e-5, name
    for r in runs["ranks"]:
        assert r["ring_spec"] == ["Shard(dim=2)"]
        assert r[f"ring_{causal}_local"] == [2, 4, 16, 16]


def test_pipeline_parallel_matches_sequential(runs):
    """test_tpu.py:299 on four gloo ranks (one layer a stage, 2
    microbatches): the logits within 1e-4 of JAX's sequential
    ``forward`` (measured 3.7e-6) and of JAX's ``pipeline_forward``
    (measured 2.1e-6); every leaf of the ``pipeline_loss`` gradient
    within 1e-4 of its norm of JAX's ``jax.grad(pipeline_loss)`` (measured
    1.1e-6), every leaf non-zero. The stacked layers are split over
    'pp', one layer a rank."""
    port, ref = runs["port"], runs["jax"]["pipe"]
    logits = port["pipe_logits"]
    assert np.abs(logits - ref["forward"]).max() < 1e-4
    assert np.abs(logits - ref["pipeline"]).max() < 1e-4
    grads = [port[f"pipe_grad_{i}"] for i in range(len(ref["grads"]))]
    assert f"pipe_grad_{len(ref['grads'])}" not in port
    for g, want in zip(grads, ref["grads"]):
        assert g.shape == want.shape
        assert np.linalg.norm(want) > 0 and np.abs(g).sum() > 0
        assert np.linalg.norm(g - want) <= 1e-4 * np.linalg.norm(want)
    for r in runs["ranks"]:
        assert r["pipe_layer_placements"] == ["(Shard(dim=0),)"]
        assert r["pipe_loss"] == pytest.approx(runs["ranks"][0]["pipe_loss"])


@pytest.mark.parametrize("name", list(DRY_CASES))
def test_seq_mesh_train_step_matches_jax(runs, name):
    """dryrun_multichip's first pass on a (2, 1, 2) data x model x seq
    mesh, each rank holding a quarter of the batch (2 rows of 32
    positions): the first loss within 1e-5 of JAX's jitted loss (relative;
    measured 7.0e-8), every gradient leaf within 1e-4 of its norm of
    JAX's (measured 9.9e-7), and one AdamW step (lr 3e-4): its loss to
    1e-5 and every updated leaf within 1e-5 of its norm of JAX's
    (measured 2.7e-7) and by at most lr anywhere (measured 2.7e-6; an
    entry whose gradient is near zero moves by about lr·sign(g), which
    follows the sign of a rounding). With ring attention, with the
    sequence gathered for attention (``use_ring_attention=False``), and
    with ``remat`` (JAX's side without it: its remat cannot take the
    mesh, and it changes no value)."""
    ref, port = runs["jax"][name], runs["port"]
    n = len(ref["leaves"])
    for r in runs["ranks"]:
        got = r[name]
        assert got["loss0"] == pytest.approx(ref["loss0"], rel=1e-5)
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
        assert got["tok_local"] == [2, 32]
        assert got["tok_placements"] == ["Shard(dim=0)", "Replicate()",
                                         "Shard(dim=1)"]
    for i in range(n):
        g, want = port[f"{name}_grad_{i}"], ref["grads"][i]
        assert np.linalg.norm(g - want) <= 1e-4 * np.linalg.norm(want), i
        p, want = port[f"{name}_leaf_{i}"], ref["leaves"][i]
        assert np.linalg.norm(p - want) <= 1e-5 * np.linalg.norm(want), i
        assert np.abs(p - want).max() <= 3e-4, i


def test_seq_loss_takes_the_halo_and_the_global_count(runs):
    """The loss on the (2, 1, 2) mesh pairs each shard's last position
    with the next shard's first token (the halo) and divides by the
    global B·(L-1). Each rank's targets are its tokens shifted by one
    with the halo appended (the last shard's last position dropped), and
    the loss matches the mean of JAX's per-position losses (rel 1e-5,
    measured 0). At these tokens the boundary pairs' losses stand far
    above the mean: dropping them shifts the loss by more than 100x that
    tolerance (measured 7.5e-3), and averaging the ranks' own means (32
    and 31 positions) by more than 10x (measured 1.6e-4), so either
    fault fails this test."""
    tokens = runs["dry_tokens"]
    nll = runs["jax"]["ring"]["nll"]
    B, Lm1 = nll.shape
    half = (Lm1 + 1) // 2
    want = nll.mean()
    no_halo = np.delete(nll, half - 1, axis=1).mean()
    rank_means = np.mean([nll[rows, cols].mean()
                          for rows in (slice(0, B // 2), slice(B // 2, B))
                          for cols in (slice(0, half), slice(half, Lm1))])
    assert abs(no_halo - want) > 100 * 1e-5 * abs(want)
    assert abs(rank_means - want) > 10 * 1e-5 * abs(want)
    for r in runs["ranks"]:
        for name in DRY_CASES:
            got = r[name]
            d, s = got["coords"]
            rows = tokens[d * B // 2:(d + 1) * B // 2]
            n = half if s == 0 else half - 1
            assert got["rows"] == [B // 2, n]
            assert got["targets"] == rows[:, s * half + 1:
                                          s * half + 1 + n].tolist()
            assert got["loss0"] == pytest.approx(want, rel=1e-5)
