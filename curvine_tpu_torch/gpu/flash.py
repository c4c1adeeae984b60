"""K3: causal flash attention for the train step, forward and backward.

Port of ``curvine_tpu/tpu/model.py:113-122`` (``_flash_attention``),
which calls the Pallas TPU kernels of
``jax.experimental.pallas.ops.tpu.flash_attention``: a ``custom_vjp`` of
one forward kernel and two backward kernels (dK/dV and dQ), with the
backward's row sums ``di`` taken by XLA between them. Here they are the
four CUDA C++ kernels of ``csrc/flash_attention.cu`` (see its note for
the design, and for why ``di`` is a kernel of its own that sums P∘dP
rather than o∘do), bound with ctypes, and an ``autograd.Function``
around them. All four are built for Hopper: TMA loads into a ring of
tiles guarded by mbarriers, ``wgmma`` products, a producer warpgroup and
two consumer warpgroups; di and dQ are one kernel template that differs
in its epilogue.

* ``flash_attention(q, k, v, causal=True, sm_scale=None)`` is the entry
  point, over ``[B, H, L, D]``. For CPU tensors it runs the plain
  versions; for CUDA tensors it launches the kernels, and raises for
  what they do not take (a dtype other than bf16, ``D != 128``,
  ``L % 128 != 0``, non-causal, a non-contiguous tensor, one that does
  not start on a 16-byte boundary, as TMA needs, an ``sm_scale`` that is
  not positive) or for a launch that fails. It never falls back to the
  plain version.
* ``flash_fwd``, ``flash_bwd_di``, ``flash_bwd_dkv`` and ``flash_bwd_dq``
  launch one kernel each on the current stream and count their launches
  (``flash_fwd.launches`` ...), where they launch and nowhere else.
* ``flash_fwd_plain``, ``flash_bwd_di_plain`` and ``flash_bwd_plain``
  compute the same functions in f32 from the same residuals (``lse``,
  the row's log-sum-exp of the scaled scores, and ``di``, the row sums
  of P∘dP), rounding P and dS to the inputs' dtype where the kernels
  do. They are the kernels' yardstick on the card and the path on the
  CPU. ``flash_attention_plain`` is the ``autograd.Function`` over them
  alone, on any device."""

from __future__ import annotations

import ctypes
import math

import torch

from curvine_tpu_torch.gpu import _build

__all__ = ["HEAD_DIM", "SEQ_TILE", "flash_attention", "flash_attention_plain",
           "flash_fwd", "flash_bwd_di", "flash_bwd_dkv", "flash_bwd_dq",
           "flash_fwd_plain", "flash_bwd_di_plain", "flash_bwd_plain",
           "check_kernel_args"]

HEAD_DIM = 128          # the one head_dim the kernels tile
SEQ_TILE = 128          # L must be a multiple (the JAX package's gate)
_MAX_BH = 65535         # B * H rides the grid's y dimension

_ARGTYPES = {
    "cv_flash_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                             ctypes.c_float, ctypes.c_void_p],
    "cv_flash_bwd_di": [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    "cv_flash_bwd_dkv": [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    "cv_flash_bwd_dq": [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def check_kernel_args(q, k, v, causal: bool = True, *more) -> None:
    """Raise ``ValueError`` for anything the kernels do not take: q, k, v
    (and any further ``[B, H, L, D]`` operand, such as ``o`` or ``do``)
    must be contiguous bf16 tensors of one shape with ``D == 128`` and
    ``L % 128 == 0``, on one device, each starting on a 16-byte boundary
    (TMA's rule for a tensor's base), and the mask causal. The device is
    checked where a kernel launches."""
    if not causal:
        raise ValueError("flash kernels: only causal attention is ported")
    ts = (q, k, v) + more
    for t in ts:
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"flash kernels take tensors, got {type(t)}")
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(f"flash kernels: operands must share one "
                             f"[B, H, L, D] shape, got {tuple(t.shape)} "
                             f"and {tuple(q.shape)}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash kernels take bf16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("flash kernels: operands must be contiguous "
                             "(call .contiguous() at the call site)")
        if t.device != q.device:
            raise ValueError(f"flash kernels: operands on {t.device} and "
                             f"{q.device}")
        _check_aligned(t)
    B, H, L, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"flash kernels: head_dim must be {HEAD_DIM}, "
                         f"got {D}")
    if L == 0 or L % SEQ_TILE:
        raise ValueError(f"flash kernels: L must be a positive multiple of "
                         f"{SEQ_TILE}, got {L}")
    if not 0 < B * H <= _MAX_BH:
        raise ValueError(f"flash kernels: B*H must be in 1..{_MAX_BH}, "
                         f"got {B * H}")


def _check_aligned(t: torch.Tensor) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"flash kernels: operands must start on a 16-byte "
                         f"boundary, got address {t.data_ptr():#x} (an "
                         f"offset view; call .clone() at the call site)")


def _on_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} kernel: {t.device} is not a CUDA device")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _scale(q: torch.Tensor, sm_scale: float | None) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None \
        else float(sm_scale)


def flash_fwd(q, k, v, sm_scale: float | None = None):
    """Launch the forward kernel: (o bf16 [B,H,L,D], lse f32 [B,H,L])."""
    check_kernel_args(q, k, v)
    scale = _scale(q, sm_scale)
    if not 0.0 < scale < math.inf:       # rows' maxima on unscaled scores
        raise ValueError(f"flash_fwd kernel: sm_scale must be positive and "
                         f"finite, got {scale}")
    _on_cuda(q, "flash_fwd")
    B, H, L, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().cv_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(), B * H, L,
                                 scale, _stream(q))
    _raise_on(rc, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


def _check_residuals(q, **rows) -> None:
    B, H, L, _ = q.shape
    for name, t in rows.items():
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, L) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash kernels: {name} must be contiguous f32 "
                             f"of shape {(B, H, L)} on {q.device}")
        _check_aligned(t)


def flash_bwd_di(q, k, v, do, lse, sm_scale: float | None = None):
    """Launch the di kernel: di = rowsum(P ∘ dP) f32 [B,H,L], with
    P = exp(S - lse) and dP = dO Vᵀ."""
    check_kernel_args(q, k, v, True, do)
    _check_residuals(q, lse=lse)
    scale = _scale(q, sm_scale)
    _on_cuda(q, "flash_bwd_di")
    B, H, L, _ = q.shape
    di = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().cv_flash_bwd_di(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), B * H, L, scale, _stream(q))
    _raise_on(rc, "flash_bwd_di")
    flash_bwd_di.launches += 1
    return di


def flash_bwd_dkv(q, k, v, do, lse, di, sm_scale: float | None = None):
    """Launch the dK/dV kernel: (dk, dv), bf16 like k and v."""
    check_kernel_args(q, k, v, True, do)
    _check_residuals(q, lse=lse, di=di)
    scale = _scale(q, sm_scale)
    _on_cuda(q, "flash_bwd_dkv")
    B, H, L, _ = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = _lib().cv_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B * H, L, scale, _stream(q))
    _raise_on(rc, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, di, sm_scale: float | None = None):
    """Launch the dQ kernel: dq, bf16 like q."""
    check_kernel_args(q, k, v, True, do)
    _check_residuals(q, lse=lse, di=di)
    scale = _scale(q, sm_scale)
    _on_cuda(q, "flash_bwd_dq")
    B, H, L, _ = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _lib().cv_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(), B * H, L, scale,
            _stream(q))
    _raise_on(rc, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_fwd.launches = 0
flash_bwd_di.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0


# ------------------------------------------------------------ plain versions

def _scores(q, k, causal: bool, sm_scale: float) -> torch.Tensor:
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        L = q.shape[2]
        above = torch.ones(L, L, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    return s


def flash_fwd_plain(q, k, v, causal: bool = True,
                    sm_scale: float | None = None):
    """Plain forward: (o in q's dtype, lse f32). P is rounded to the
    inputs' dtype before P V, as in the kernel."""
    s = _scores(q, k, causal, _scale(q, sm_scale))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse.unsqueeze(-1))
    o = torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)
    return o, lse


def flash_bwd_di_plain(q, k, v, do, lse, causal: bool = True,
                       sm_scale: float | None = None) -> torch.Tensor:
    """Plain di = rowsum(P ∘ dP) in f32, [B, H, L]: rowsum(o ∘ do) for the
    exact o, free of o's rounding to the inputs' dtype."""
    p = torch.exp(_scores(q, k, causal, _scale(q, sm_scale))
                  - lse.unsqueeze(-1))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return (p * dp).sum(-1)


def flash_bwd_plain(q, k, v, do, lse, di, causal: bool = True,
                    sm_scale: float | None = None):
    """Plain backward from the forward's residuals: (dq, dk, dv) in the
    inputs' dtype. P is rounded before dV = Pᵀ dO and dS before dK and
    dQ, as in the kernels."""
    scale = _scale(q, sm_scale)
    dt = q.dtype
    p = torch.exp(_scores(q, k, causal, scale) - lse.unsqueeze(-1))
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - di.unsqueeze(-1)) * scale).to(dt).float()
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dq = torch.matmul(ds, k.float())
    return dq.to(dt), dk.to(dt), dv.to(k.dtype)


# ------------------------------------------------------------------ autograd

class _Flash(torch.autograd.Function):
    """Kernels for CUDA tensors, plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        if q.device.type == "cpu":
            return _FlashPlain.forward(ctx, q, k, v, causal, sm_scale)
        if q.device.type != "cuda":
            raise ValueError(f"flash_attention: no path for {q.device}")
        check_kernel_args(q, k, v, causal)
        o, lse = flash_fwd(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        do = do.contiguous()
        if q.device.type == "cpu":
            return _FlashPlain.backward(ctx, do)
        di = flash_bwd_di(q, k, v, do, lse, ctx.sm_scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, ctx.sm_scale)
        dq = flash_bwd_dq(q, k, v, do, lse, di, ctx.sm_scale)
        return dq, dk, dv, None, None


class _FlashPlain(torch.autograd.Function):
    """The plain versions alone, on any device."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_fwd_plain(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        di = flash_bwd_di_plain(q, k, v, do, lse, ctx.causal, ctx.sm_scale)
        dq, dk, dv = flash_bwd_plain(q, k, v, do, lse, di, ctx.causal,
                                     ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: float | None = None) -> torch.Tensor:
    """Causal attention over ``[B, H, L, D]`` with gradients: the kernels
    for CUDA tensors, the plain versions for CPU tensors."""
    return _Flash.apply(q, k, v, causal, sm_scale)


def flash_attention_plain(q, k, v, causal: bool = True,
                          sm_scale: float | None = None) -> torch.Tensor:
    """The same function through the plain versions on any device: the
    kernels' yardstick for a whole model on the card."""
    return _FlashPlain.apply(q, k, v, causal, sm_scale)
