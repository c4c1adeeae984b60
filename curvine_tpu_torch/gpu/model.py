"""Training consumer: the decoder-only transformer LM of the JAX package.

Port of ``curvine_tpu/tpu/model.py:30-244`` for one device: the same
configuration, the same parameter tree (names, shapes, ``x @ w``
orientation), the same forward pass, chunked cross entropy and AdamW
step. Parameters are a plain dict of leaf tensors, as JAX's pytree is,
so a JAX-initialised tree loads one to one (``params_from_jax``).

Where the JAX package takes the Pallas flash attention on a TPU, the
port takes K3 (``gpu/flash.py``, CUDA kernels) on a CUDA device; on the
CPU it takes ``dense_attention``, as the JAX package does off the TPU.
Not ported yet: the MoE FFN, ring attention and the mesh shardings
(``model.py:141-156, 247-292``), which wait for the mesh slice.
``use_ring_attention`` is kept as a field and, as in the JAX package
without a mesh, changes nothing.

The train step differs in form only: PyTorch updates the parameters in
place and the optimizer carries its state, so ``make_train_step``'s
step takes ``(params, tokens)`` and returns the loss."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from curvine_tpu_torch.device import default_device
from curvine_tpu_torch.gpu.attention import dense_attention
from curvine_tpu_torch.gpu.flash import flash_attention

__all__ = ["ModelConfig", "init_params", "leaves", "n_params",
           "params_from_jax", "params_to_numpy", "forward_hidden",
           "forward", "loss_fn", "make_optimizer", "make_train_step"]


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
    moe_experts: int = 0       # >0: MoE FFN (not ported yet: raises)
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


def _no_moe(cfg: ModelConfig) -> None:
    if cfg.moe_experts > 0:
        raise NotImplementedError("the MoE FFN is not ported yet")


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device=None) -> dict:
    """Random parameters, drawn from ``generator`` on its own device and
    placed on ``device`` (``default_device()`` when None: the card, or an
    error without one; the CPU only when asked for): the JAX tree's
    names and shapes, weights N(0, 1/fan_in), norms 1."""
    _no_moe(cfg)
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
        layers.append({
            "ln1": ones(D),
            "wq": dense(D, (D, D)), "wk": dense(D, (D, D)),
            "wv": dense(D, (D, D)), "wo": dense(D, (D, D)),
            "ln2": ones(D),
            "w1": dense(D, (D, Fd)), "w2": dense(Fd, (Fd, D)),
        })
    return {"embed": embed, "pos": pos, "ln_f": ones(D), "layers": layers}


def leaves(params: dict) -> list[torch.Tensor]:
    """The tensors in ``jax.tree.leaves`` order (dict keys sorted)."""
    out = []
    for key in sorted(params):
        val = params[key]
        if key == "layers":
            for layer in val:
                out.extend(layer[k] for k in sorted(layer))
        else:
            out.append(val)
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
    tensors come back as their uint16 bits (numpy has no bfloat16)."""
    def to_np(t):
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


def _attention(x, layer, cfg: ModelConfig):
    B, L, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = (x @ layer["wq"]).reshape(B, L, H, hd).transpose(1, 2)
    k = (x @ layer["wk"]).reshape(B, L, H, hd).transpose(1, 2)
    v = (x @ layer["wv"]).reshape(B, L, H, hd).transpose(1, 2)
    if _flash_eligible(cfg, L, x.device):
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=True, sm_scale=1.0 / math.sqrt(hd))
    else:
        o = dense_attention(q, k, v, causal=True)
    o = o.transpose(1, 2).reshape(B, L, D)
    return o @ layer["wo"]


def _block(x, layer, cfg: ModelConfig):
    _no_moe(cfg)
    x = x + _attention(_rmsnorm(x, layer["ln1"]), layer, cfg)
    h = _rmsnorm(x, layer["ln2"])
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h @ layer["w1"], approximate="tanh") @ layer["w2"]
    return x + h


def forward_hidden(params: dict, tokens: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """tokens [B, L] int → final hidden states [B, L, D] (model dtype)."""
    B, L = tokens.shape
    x = params["embed"][tokens.long()] + params["pos"][:L]
    for layer in params["layers"]:
        if cfg.remat:
            x = checkpoint(_block, x, layer, cfg, use_reentrant=False)
        else:
            x = _block(x, layer, cfg)
    return _rmsnorm(x, params["ln_f"])


def forward(params: dict, tokens: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """tokens [B, L] int → logits [B, L, V] f32 (a model-dtype matmul,
    cast afterwards)."""
    x = forward_hidden(params, tokens, cfg)
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


def loss_fn(params: dict, tokens: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross entropy; the model runs on all L positions (so
    flash stays eligible) and the last position predicts nothing."""
    x = forward_hidden(params, tokens, cfg)
    x = x[:, :-1].reshape(-1, x.shape[-1])
    targets = tokens[:, 1:].reshape(-1).long()
    if cfg.ce_chunk > 0:
        return _chunked_ce(x, targets, params["embed"], cfg.ce_chunk)
    return _oneshot_ce(x, targets, params["embed"])


def make_optimizer(params: dict, lr: float = 3e-4) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=0.01)``: b1 0.9, b2 0.999, eps 1e-8,
    decoupled decay on every leaf (no mask), moments in the parameters'
    dtype."""
    return torch.optim.AdamW(leaves(params), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=0.01)


def make_train_step(cfg: ModelConfig, optimizer: torch.optim.Optimizer):
    """A step ``train_step(params, tokens) -> loss``: loss and gradients,
    then one optimizer update of ``params`` in place. The loss is
    returned without a sync (a 0-d tensor on the parameters' device)."""

    def train_step(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens, cfg)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step
