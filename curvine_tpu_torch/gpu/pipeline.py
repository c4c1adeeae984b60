"""Pipeline parallelism over a ``pp`` mesh axis: GPipe stages.

Port of ``curvine_tpu/tpu/pipeline.py``. The layers are stacked (a
leading [n_layers] dim, ``stack_layers``) and split over ``pp``
(``shard_stacked``: DTensors ``Shard(0)``), so each rank owns
n_layers/S contiguous layers. Microbatches flow around the ring: at step
t, stage s computes microbatch t - s and ``ppermute``s its activations
to stage s + 1; M + S - 1 steps in all, the classic bubble. The
embedding and the unembedding stay outside the pipelined region, on
every rank.

As in the reference, every stage computes at every step and the same
program runs on every rank: stage 0 takes microbatch ``clip(t, 0,
M-1)`` and the others the state received, chosen by a mask, not by a
branch on the rank; each stage keeps its outputs times a mask that is 1
on the last stage only, and the outputs are summed over ``pp``. The
ranks' autograd graphs then have one structure, so their backward shifts
meet in one order (``gpu/mesh.py::ppermute``). The stages call the
model's ``_block(h, layer, cfg, None)``, so on the card K3 runs wherever
its gate admits the shapes."""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from curvine_tpu_torch.gpu.broadcast import broadcast_params
from curvine_tpu_torch.gpu.mesh import P, ppermute
from curvine_tpu_torch.gpu.model import ModelConfig, _block, _rmsnorm

__all__ = ["stack_layers", "stacked_specs", "shard_stacked",
           "pipeline_forward", "pipeline_loss", "next_token_nll"]


def stack_layers(params: dict) -> dict:
    """[{k: w} per layer] → {k: [n_layers, ...]} for pp sharding. Every
    leaf of the result is a new leaf tensor (a copy, requiring grad where
    the input's does), so an update in place of one tree leaves the other
    as it was, as JAX's immutable arrays are."""
    def leaf(t):
        return t.detach().clone().requires_grad_(t.requires_grad)

    layers = params["layers"]
    out = {k: leaf(v) for k, v in params.items() if k != "layers"}
    out["layers"] = {
        k: torch.stack([layer[k].detach() for layer in layers])
        .requires_grad_(layers[0][k].requires_grad) for k in layers[0]}
    return out


def stacked_specs(params_stacked: dict) -> dict:
    """Specs: the stacked layer weights split over 'pp' on dim 0, the
    rest replicated."""
    base = {"embed": P(None, None), "pos": P(None, None), "ln_f": P(None)}
    layer_specs = {k: P("pp", *([None] * (v.dim() - 1)))
                   for k, v in params_stacked["layers"].items()}
    return {**base, "layers": layer_specs}


def shard_stacked(params_stacked: dict, mesh) -> dict:
    """Each leaf a DTensor on ``mesh`` laid out by ``stacked_specs``."""
    return broadcast_params(params_stacked, mesh,
                            stacked_specs(params_stacked))


def _on_pp(mesh, placement) -> list:
    return [placement if a == "pp" else Replicate()
            for a in mesh.mesh_dim_names]


def _grad_summed(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x``, computed alike on every rank, as each rank's input to the
    pipelined region: the identity forward, and backward the sum over
    'pp' of the ranks' gradients, as shard_map sums the cotangent of an
    input it does not split."""
    return DTensor.from_local(x, mesh, _on_pp(mesh, Replicate()),
                              run_check=False).to_local(
        grad_placements=_on_pp(mesh, Partial()))


def pipeline_forward(params_stacked: dict, tokens: torch.Tensor,
                     cfg: ModelConfig, mesh, microbatches: int = 2
                     ) -> torch.Tensor:
    """tokens [B, L] (a plain tensor, the same on every rank) with B
    divisible by ``microbatches`` → logits [B, L, V] f32, the same on
    every rank. The stages are the ranks of ``mesh``'s 'pp' axis;
    ``cfg.n_layers`` must divide evenly over them."""
    S = mesh.size(mesh.mesh_dim_names.index("pp"))
    if cfg.n_layers % S:
        raise ValueError(f"{cfg.n_layers} layers do not divide over {S} "
                         f"stages")
    B, L = tokens.shape
    M = microbatches
    if B % M:
        raise ValueError(f"a batch of {B} does not divide into {M} "
                         f"microbatches")
    embed, pos, ln_f = (params_stacked[k].to_local()
                        for k in ("embed", "pos", "ln_f"))
    x = embed[tokens.long()] + pos[:L]
    xs = _grad_summed(x, mesh).reshape(M, B // M, L, cfg.d_model)
    # this stage's layers, each leaf unbound once: the backward stacks the
    # layers' gradients in one op, where indexing the stacked leaf in
    # each use would fill and add a gradient of the whole stack per use
    keys = sorted(params_stacked["layers"])
    layers = [dict(zip(keys, leaves)) for leaves in zip(*(
        params_stacked["layers"][k].to_local().unbind(0) for k in keys))]
    stage = mesh.get_local_rank("pp")
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(float(stage == S - 1), dtype=x.dtype,
                        device=x.device)
    state = torch.zeros_like(xs[0])
    outs = []
    for t in range(M + S - 1):
        h = torch.where(first, xs[min(t, M - 1)], state)
        for layer in layers:
            h = _block(h, layer, cfg, None)
        if t >= S - 1:
            # only the last stage's value is real; the others are zeroed
            # so that the sum over 'pp' recovers it exactly
            outs.append(h * last)
        state = ppermute(h, mesh, "pp")
    out = DTensor.from_local(torch.stack(outs), mesh,
                             _on_pp(mesh, Partial()),
                             run_check=False).full_tensor()
    x = _rmsnorm(out.reshape(B, L, cfg.d_model), ln_f)
    return (x @ embed.T).float()


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor
                   ) -> torch.Tensor:
    """The mean negative log-likelihood of ``tokens[:, 1:]`` under
    ``log_softmax(logits[:, :-1])``, over the full f32 logits."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None].long()).mean()


def pipeline_loss(params_stacked: dict, tokens: torch.Tensor,
                  cfg: ModelConfig, mesh, microbatches: int = 2
                  ) -> torch.Tensor:
    """Next-token cross entropy of ``pipeline_forward``'s logits."""
    return next_token_nll(pipeline_forward(params_stacked, tokens, cfg,
                                           mesh, microbatches), tokens)
