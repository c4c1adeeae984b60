"""Training consumer: the decoder-only transformer LM of the JAX package.

Port of ``curvine_tpu/tpu/model.py``: the same configuration, the same
parameter tree (names, shapes, ``x @ w`` orientation), the same forward
pass, MoE FFN, chunked cross entropy, AdamW step and mesh shardings.
Parameters are a plain dict of leaf tensors, as JAX's pytree is, so a
JAX-initialised tree loads one to one (``params_from_jax``).

Where the JAX package takes the Pallas flash attention on a TPU, the
port takes K3 (``gpu/flash.py``, CUDA kernels) on a CUDA device; on the
CPU it takes ``dense_attention``, as the JAX package does off the TPU.

Sharding recipe (Megatron-style TP over the ``model`` axis, experts over
``ep``; ``_PARAM_SPECS``), on a ``gpu/mesh.py`` mesh: ``shard_params``
makes each leaf a DTensor laid out by its spec, and the model functions
take the ``mesh``. Where XLA's sharding propagation chooses the
activations' layout, DTensor's would choose others (a partial sum on
``model`` after the embedding, the batch split over ``model``), so the
activations are pinned to the reference docstring's ``P('data', 'seq',
None)`` at each block's entry and before each RMSNorm, and the pinned
tensor is the one used on (by the residual too: a pin beside its
unpinned input would regroup the sums of the gradient's terms, which on
a mesh of one would then differ from the unsharded step's in the last
bit); attention runs under
``mesh.shard_map`` on each rank's local heads (K3 on a CUDA mesh, as
without one), and the gradients, partial sums over ``data`` and ``seq``
after the backward, are reduced once before the optimizer's step, as
DDP does. The sequence may be split over a ``seq`` axis: with
``use_ring_attention`` and a mesh that has ``seq`` (even of one rank),
attention is the ring of ``gpu/attention.py`` over it, as in the
reference; otherwise q, k and v are gathered over ``seq`` first (as XLA
does for the reference) and each rank attends its heads over the whole
sequence. A rank adds the positions of its own part of the sequence,
and the loss pairs its last position with the next ``seq`` rank's first
token.

The train step differs in form only: PyTorch updates the parameters in
place and the optimizer carries its state, so ``make_train_step``'s
step takes ``(params, tokens)`` and returns the loss."""

from __future__ import annotations

import functools
import importlib
import math
import sys
import threading
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.utils.checkpoint import checkpoint

from curvine_tpu_torch.device import default_device
from curvine_tpu_torch.gpu.attention import (dense_attention,
                                             ring_attention_sharded,
                                             ring_spec)
from curvine_tpu_torch.gpu.broadcast import broadcast_params
from curvine_tpu_torch.gpu.flash import flash_attention
from curvine_tpu_torch.gpu.mesh import (P, placements, ppermute, shard_map,
                                        tree_map)

__all__ = ["ModelConfig", "init_params", "leaves", "n_params",
           "params_from_jax", "params_to_numpy", "forward_hidden",
           "forward", "loss_fn", "make_optimizer", "make_train_step",
           "param_spec_tree", "shard_params", "batch_spec"]


def _import_dynamo() -> None:
    """Import ``torch._dynamo`` on a thread of its own. torch imports it
    at the first call of a function it wraps in ``_disable_dynamo`` (an
    optimizer's ``add_param_group``, DTensor's dispatch), and one of the
    modules it loads calls ``torch.fx.wrap``, which keeps its own frame
    in a local: a cycle that holds every frame then on the stack, and
    their locals (the first optimizer, the parameters being sharded),
    until the cycle collector runs. Imported first on another thread, the
    frames held are that thread's, and ``del`` frees what a caller drops
    (ROADMAP C3)."""
    if "torch._dynamo" not in sys.modules:
        t = threading.Thread(target=importlib.import_module,
                             args=("torch._dynamo",), name="import-dynamo")
        t.start()
        t.join()


_import_dynamo()


@dataclass(frozen=True)
class ModelConfig:
    vocab: int = 32_000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq: int = 2048
    dtype: str = "bfloat16"
    use_ring_attention: bool = False
    remat: bool = False        # torch.utils.checkpoint each block
    moe_experts: int = 0       # >0: MoE FFN, experts sharded over 'ep'
    # K3 flash attention on a CUDA device (gpu/flash.py). Eligible where
    # head_dim % 128 == 0 and seq % 128 == 0, as in the JAX package; the
    # kernels take head_dim 128 and raise for anything else they see.
    use_flash_attention: bool = False
    # Cross entropy in chunks of this many tokens (0 = one-shot); each
    # chunk's [chunk, vocab] f32 logits are recomputed in the backward.
    ce_chunk: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def tiny() -> "ModelConfig":
        return ModelConfig(vocab=256, d_model=64, n_heads=4, n_layers=2,
                           d_ff=128, max_seq=128)


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device=None) -> dict:
    """Random parameters, drawn from ``generator`` on its own device and
    placed on ``device`` (``default_device()`` when None: the card, or an
    error without one; the CPU only when asked for): the JAX tree's
    names and shapes, weights N(0, 1/fan_in), norms 1."""
    dt = cfg.torch_dtype()
    device = default_device() if device is None else torch.device(device)
    D, Fd = cfg.d_model, cfg.d_ff

    def dense(fan_in, shape):
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32) / math.sqrt(fan_in)
        return w.to(device=device, dtype=dt).requires_grad_(True)

    def ones(n):
        return torch.ones(n, dtype=dt, device=device, requires_grad=True)

    embed = dense(D, (cfg.vocab, D))
    pos = dense(D, (cfg.max_seq, D))
    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            "ln1": ones(D),
            "wq": dense(D, (D, D)), "wk": dense(D, (D, D)),
            "wv": dense(D, (D, D)), "wo": dense(D, (D, D)),
            "ln2": ones(D),
        }
        if cfg.moe_experts > 0:
            E = cfg.moe_experts
            layer["router"] = dense(D, (D, E))
            layer["ew1"] = dense(D, (E, D, Fd))
            layer["ew2"] = dense(Fd, (E, Fd, D))
        else:
            layer["w1"] = dense(D, (D, Fd))
            layer["w2"] = dense(Fd, (Fd, D))
        layers.append(layer)
    return {"embed": embed, "pos": pos, "ln_f": ones(D), "layers": layers}


def leaves(params: dict) -> list[torch.Tensor]:
    """The tensors in ``jax.tree.leaves`` order (dict keys sorted); the
    layers a list of dicts, or one dict of stacked leaves
    (``gpu/pipeline.py::stack_layers``)."""
    out = []
    for key in sorted(params):
        val = params[key]
        if key != "layers":
            out.append(val)
            continue
        for layer in [val] if isinstance(val, dict) else val:
            out.extend(layer[k] for k in sorted(layer))
    return out


def n_params(params: dict) -> int:
    return sum(t.numel() for t in leaves(params))


def _from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)                     # an own, writable copy
    if a.dtype.name == "bfloat16":      # ml_dtypes: torch refuses it
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device).requires_grad_(True)


def params_from_jax(tree: dict, device=None) -> dict:
    """The JAX package's parameter tree, as numpy arrays (``np.asarray``
    of each leaf), as the port's parameters on ``device``
    (``default_device()`` when None: the card, or an error without one;
    the CPU only when asked for). bf16 arrays are carried bit for bit
    through their uint16 bits."""
    device = default_device() if device is None else torch.device(device)
    return {
        "embed": _from_numpy(tree["embed"], device),
        "pos": _from_numpy(tree["pos"], device),
        "ln_f": _from_numpy(tree["ln_f"], device),
        "layers": [{k: _from_numpy(v, device) for k, v in layer.items()}
                   for layer in tree["layers"]],
    }


def params_to_numpy(params: dict) -> dict:
    """The reverse of ``params_from_jax``: numpy arrays on the host; bf16
    tensors come back as their uint16 bits (numpy has no bfloat16). A
    DTensor leaf is gathered whole first (``full_tensor``, a collective
    every rank of its mesh calls), as ``np.asarray`` gathers a sharded
    ``jax.Array``."""
    def to_np(t):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    return {
        "embed": to_np(params["embed"]), "pos": to_np(params["pos"]),
        "ln_f": to_np(params["ln_f"]),
        "layers": [{k: to_np(v) for k, v in layer.items()}
                   for layer in params["layers"]],
    }


def _rmsnorm(x, scale):
    # variance in f32; bf16 x times the f32 rsqrt promotes to f32, is
    # cast back to x's dtype, and only then scaled (model.py:101-103)
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale


def _flash_eligible(cfg: ModelConfig, L: int, device: torch.device) -> bool:
    """The reference's gate (``curvine_tpu/tpu/model.py:106-110``) with
    the card for the TPU: head_dim and L multiples of 128. What K3's
    kernels do not take among the configs it admits (float32, head_dim
    256) raises in ``flash.check_kernel_args`` before any launch; it is
    never sent quietly to dense attention on the card."""
    return (cfg.use_flash_attention
            and device.type == "cuda"
            and cfg.head_dim % 128 == 0
            and L % 128 == 0)


def _attend(q, k, v, cfg: ModelConfig):
    """Causal attention over [B, H, L, hd] plain tensors: K3 where the
    gate admits it, else dense."""
    if _flash_eligible(cfg, q.shape[2], q.device):
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True,
                               sm_scale=1.0 / math.sqrt(q.shape[-1]))
    return dense_attention(q, k, v, causal=True)


def _mm(x, w, mesh):
    """``x @ w`` for activations [B, L, K] and a weight [K, N]. Under a
    mesh with a 'seq' axis, as a product batched over B (the weight
    expanded, not copied): DTensor flattens B and L for the plain
    product, and with L split over 'seq' (even a 'seq' of one rank) torch
    2.11 refuses the flatten ("Attempted to flatten multiple dimensions,
    with dimension 1 being sharded") and torch 2.13 takes minutes to
    propagate its strided layout. The values are the same; the expanded
    weight's gradient is summed over B in the backward."""
    if mesh is None or "seq" not in mesh.mesh_dim_names:
        return x @ w
    return torch.bmm(x, w.expand(x.shape[0], *w.shape))


def _attention(x, layer, cfg: ModelConfig, mesh=None):
    B, L, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = _mm(x, layer["wq"], mesh).reshape(B, L, H, hd).transpose(1, 2)
    k = _mm(x, layer["wk"], mesh).reshape(B, L, H, hd).transpose(1, 2)
    v = _mm(x, layer["wv"], mesh).reshape(B, L, H, hd).transpose(1, 2)
    if mesh is None:
        o = _attend(q, k, v, cfg)
    else:
        names = mesh.mesh_dim_names
        if cfg.use_ring_attention and "seq" in names:
            # each rank's rows and heads, its part of the sequence
            spec = ring_spec(mesh)
            attend = functools.partial(ring_attention_sharded, mesh=mesh)
        else:
            # each rank's local heads over the whole sequence:
            # [B/data, H/model, L, hd]
            spec = P("data", "model" if "model" in names else None)
            attend = shard_map(functools.partial(_attend, cfg=cfg), mesh,
                               (spec,) * 3, spec)
        want, got = placements(mesh, spec), list(q.placements)
        if got != want:
            # with one head, the reshape leaves the 'model' split on
            # head_dim; without the ring, a 'seq' split must be gathered:
            # lay q, k, v out as the attention takes them, and o back as
            # q was
            q, k, v = (t.redistribute(mesh, want) for t in (q, k, v))
        o = attend(q, k, v)
        if got != want:
            o = o.redistribute(mesh, got)
    o = o.transpose(1, 2).reshape(B, L, D)
    return _mm(o, layer["wo"], mesh)


def _moe_ffn(x, layer, cfg: ModelConfig):
    """Expert-parallel FFN (model.py:141-156): experts sharded over the
    'ep' mesh axis (weights P('ep', …)); the expert einsums run on each
    rank's experts and the combine sums over 'ep'. Soft top-2 routing
    in f32: dense compute, static shapes."""
    gates = torch.softmax((x @ layer["router"]).float(), dim=-1)
    # keep the top-2 gates, renormalise (still differentiable)
    top2 = torch.topk(gates, 2, dim=-1).values[..., -1:]
    gates = torch.where(gates >= top2, gates, torch.zeros_like(gates))
    gates = gates / gates.sum(-1, keepdim=True)
    h = torch.einsum("bld,edf->belf", x, layer["ew1"])
    h = F.gelu(h, approximate="tanh")
    y = torch.einsum("belf,efd->beld", h, layer["ew2"])
    return torch.einsum("beld,ble->bld", y, gates.to(x.dtype))


def _act(mesh) -> list:
    """The activations' [B, L, D] layout, the reference docstring's
    P('data', 'seq', None)."""
    return placements(mesh, P(*batch_spec(mesh), None))


def _pin(x, mesh):
    """Under a mesh, ``x`` laid out as the activations are; without one,
    ``x``."""
    if mesh is None:
        return x
    return x.redistribute(mesh, _act(mesh))


def _rows_partial(mesh) -> list:
    """Partial sums over the axes that split the rows and the sequence
    ('data', 'seq'), replicated over the others."""
    return [Partial() if a in ("data", "seq") else Replicate()
            for a in mesh.mesh_dim_names]


def _whole(param, mesh):
    """A parameter whole on this rank, as a plain tensor, for code that
    works on this rank's rows (the embedding lookup, the loss): its
    gradient goes back as a partial sum over 'data' and 'seq', the axes
    of the rows and the positions."""
    return param.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=_rows_partial(mesh))


def _seq(mesh) -> tuple[int, int]:
    """The size of the mesh's 'seq' axis and this rank's coordinate on
    it: (1, 0) without one."""
    names = mesh.mesh_dim_names
    if "seq" not in names:
        return 1, 0
    return mesh.size(names.index("seq")), mesh.get_local_rank("seq")


def _block(x, layer, cfg: ModelConfig, mesh=None):
    x = _pin(x, mesh)
    x = x + _attention(_rmsnorm(x, layer["ln1"]), layer, cfg, mesh)
    x = _pin(x, mesh)
    h = _rmsnorm(x, layer["ln2"])
    if cfg.moe_experts > 0:
        h = _moe_ffn(h, layer, cfg)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = _mm(F.gelu(_mm(h, layer["w1"], mesh), approximate="tanh"),
                layer["w2"], mesh)
    return x + h


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                   mesh=None) -> torch.Tensor:
    """tokens [B, L] int → final hidden states [B, L, D] (model dtype).
    Under ``mesh``, params and tokens are DTensors on it (``shard_params``,
    ``batch_spec``)."""
    return _hidden(params, tokens, cfg, mesh, _table(params, mesh))


def _table(params: dict, mesh) -> torch.Tensor:
    """The embedding table whole on this rank: the parameter, or under
    ``mesh`` the table gathered as a plain tensor (``_whole``)."""
    return params["embed"] if mesh is None else _whole(params["embed"], mesh)


def _hidden(params: dict, tokens: torch.Tensor, cfg: ModelConfig, mesh,
            embed: torch.Tensor) -> torch.Tensor:
    """``forward_hidden`` with ``embed``, ``_table``'s result."""
    B, L = tokens.shape
    if mesh is None:
        x = embed[tokens.long()] + params["pos"][:L]
    else:
        n_seq, k = _seq(mesh)
        if L % n_seq:
            raise ValueError(f"a sequence of {L} does not split evenly "
                             f"over a 'seq' axis of {n_seq}")
        # the lookup on this rank's rows and positions, in plain tensors:
        # its backward on DTensors (index_put) fails sharding propagation
        # in torch 2.11
        n = L // n_seq
        x = DTensor.from_local(
            embed[tokens.to_local().long()]
            + _whole(params["pos"], mesh)[k * n:(k + 1) * n], mesh,
            _act(mesh), run_check=False)
    for layer in params["layers"]:
        if cfg.remat:
            x = checkpoint(_block, x, layer, cfg, mesh, use_reentrant=False)
        else:
            x = _block(x, layer, cfg, mesh)
    return _rmsnorm(_pin(x, mesh), params["ln_f"])


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            mesh=None) -> torch.Tensor:
    """tokens [B, L] int → logits [B, L, V] f32 (a model-dtype matmul,
    cast afterwards)."""
    x = forward_hidden(params, tokens, cfg, mesh)
    return (x @ params["embed"].T).float()


def _ce_chunk(xs, ts, embed):
    logits = (xs @ embed.T).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, ts.clamp_min(0)[:, None])[:, 0]
    return torch.where(ts >= 0, nll, torch.zeros_like(nll)).sum()


def _chunked_ce(x, targets, embed, chunk: int):
    """Cross entropy over [N, D] hidden states in ``chunk``-token slices,
    each under ``torch.utils.checkpoint``: only one slice's [chunk, V]
    f32 logits are alive at a time, forward or backward. targets < 0 are
    padding and contribute nothing; the sum is divided by the unpadded
    N."""
    N = x.shape[0]
    pad = (-N) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for xs, ts in zip(x.split(chunk), targets.split(chunk)):
        total = total + checkpoint(_ce_chunk, xs, ts, embed,
                                   use_reentrant=False)
    return total / N


def _oneshot_ce(x, targets, embed):
    """Cross entropy over [N, D] hidden states with all [N, V] f32 logits
    at once."""
    logp = torch.log_softmax((x @ embed.T).float(), dim=-1)
    return -logp.gather(1, targets[:, None]).mean()


def loss_fn(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            mesh=None) -> torch.Tensor:
    """Next-token cross entropy; the model runs on all L positions (so
    flash stays eligible) and the last position predicts nothing. Under
    ``mesh`` the loss comes back whole on every rank, a plain tensor:
    each rank's mean over its own positions, weighted by its share of
    the B·(L-1) of the batch, summed over 'data' and 'seq'."""
    # under a mesh the table is gathered once a step, shared by the
    # lookup and the loss: the fewest bytes of the three layouts that
    # scripts/mesh_embed_bytes.py counts (ROADMAP C4)
    embed = _table(params, mesh)
    x = _hidden(params, tokens, cfg, mesh, embed)
    B, L = tokens.shape
    if mesh is None:
        x, targets = x[:, :-1], tokens[:, 1:]
    else:
        x, targets = _next_tokens(*_local_rows(x, tokens, mesh), mesh)
    x = x.reshape(-1, x.shape[-1])
    targets = targets.reshape(-1).long()
    if cfg.ce_chunk > 0:
        loss = _chunked_ce(x, targets, embed, cfg.ce_chunk)
    else:
        loss = _oneshot_ce(x, targets, embed)
    if mesh is None:
        return loss
    # a sum over 'data' and 'seq' of the ranks' means, each weighted by
    # its share of the global count (1.0 on a mesh of one: the loss is
    # the unsharded one's, bit for bit); its backward hands each rank
    # the loss's gradient
    return DTensor.from_local(loss * (x.shape[0] / (B * (L - 1))), mesh,
                              _rows_partial(mesh)).full_tensor()


def _local_rows(x, tokens, mesh):
    """The cross entropy's operands on this rank, as plain tensors: its
    rows of the hidden states and tokens (the batch over 'data'). The
    loss is computed on them and the whole table by the unsharded code,
    so its integer indexing never meets DTensor's sharding propagation
    (the gather's index ops fail it in torch 2.11); the hidden states'
    gradient goes back laid out as the rows are."""
    rows = _pin(x, mesh)
    return rows.to_local(grad_placements=rows.placements), tokens.to_local()


def _next_tokens(x, tokens, mesh):
    """This rank's hidden states [b, n, D] and tokens [b, n] paired with
    the tokens they predict. With the sequence over 'seq', a part's last
    position predicts the next part's first token, a halo of integers
    received from the next 'seq' rank (no gradient); the sequence's last
    position predicts nothing and is dropped, as without a mesh."""
    n_seq, k = _seq(mesh)
    if n_seq == 1:
        return x[:, :-1], tokens[:, 1:]
    halo = ppermute(tokens[:, :1], mesh, "seq", -1)
    if k == n_seq - 1:
        return x[:, :-1], tokens[:, 1:]
    return x, torch.cat([tokens[:, 1:], halo], dim=1)


def make_optimizer(params: dict, lr: float = 3e-4) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=0.01)``: b1 0.9, b2 0.999, eps 1e-8,
    decoupled decay on every leaf (no mask), moments in the parameters'
    dtype."""
    return torch.optim.AdamW(leaves(params), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=0.01)


def make_train_step(cfg: ModelConfig, optimizer: torch.optim.Optimizer,
                    mesh=None):
    """A step ``train_step(params, tokens) -> loss``: loss and gradients,
    then one optimizer update of ``params`` in place. The loss is
    returned without a sync (a 0-d tensor on the parameters' device).
    Under ``mesh`` (params from ``shard_params``, tokens laid out by
    ``batch_spec``), each gradient is reduced to its parameter's layout
    once, before the update."""

    def train_step(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens, cfg, mesh)
        loss.backward()
        if mesh is not None:
            for p in leaves(params):
                if p.grad is not None and p.grad.placements != p.placements:
                    p.grad = p.grad.redistribute(p.device_mesh,
                                                 p.placements)
        optimizer.step()
        return loss.detach()

    return train_step


# ---------------- shardings ----------------

_PARAM_SPECS = {
    "embed": P(None, "model"),
    "pos": P(None, None),
    "ln_f": P(None),
    "ln1": P(None), "ln2": P(None),
    "wq": P(None, "model"), "wk": P(None, "model"), "wv": P(None, "model"),
    "wo": P("model", None),
    "w1": P(None, "model"), "w2": P("model", None),
    # MoE: experts sharded over 'ep'
    "router": P(None, None),
    "ew1": P("ep", None, None), "ew2": P("ep", None, None),
}


def param_spec_tree(params: dict) -> dict:
    """Spec tree matching init_params structure."""
    def spec_of(path_leaf):
        return _PARAM_SPECS.get(path_leaf, P())

    return {
        "embed": spec_of("embed"), "pos": spec_of("pos"),
        "ln_f": spec_of("ln_f"),
        "layers": [{k: spec_of(k) for k in layer}
                   for layer in params["layers"]],
    }


def _sanitize(spec: P, mesh) -> P:
    """Drop axes the mesh doesn't have (e.g. 'ep' on a dp×tp mesh)."""
    return P(*(a if a in mesh.mesh_dim_names else None for a in spec))


def shard_params(params: dict, mesh) -> dict:
    """Each leaf as a DTensor on ``mesh``, laid out by its spec: a leaf
    that requires grad stays one (a new leaf)."""
    specs = tree_map(lambda s: _sanitize(s, mesh), param_spec_tree(params))
    return broadcast_params(params, mesh, specs)


def batch_spec(mesh) -> P:
    """tokens [B, L]: batch over data, seq over seq (when present)."""
    seq = "seq" if "seq" in mesh.mesh_dim_names else None
    return P("data", seq)

