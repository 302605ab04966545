"""Flash attention: online-softmax attention with a kernel backward.

Counterpart of ``deeplearning4j_tpu/kernels/flash_attention.py``. On
CUDA tensors the wrappers launch the hand-written Hopper kernels:

- ``csrc/flash_attention_fwd.cu`` — o and ``lse = m + log l``
  (the Pallas ``_flash_fwd``);
- ``csrc/flash_attention_bwd.cu`` — the dq kernel (whose prologue also
  computes ``delta = rowsum(o * g)``) and the dk/dv kernel (the Pallas
  ``_flash_bwd``), two kernels so no block adds into another's output.

Their headers say what bounds them and how they are laid out. On CPU
tensors :func:`flash_attention` and :func:`flash_attention_with_lse` run
:func:`flash_attention_plain` / :func:`flash_attention_with_lse_plain`,
whose gradients come from autograd. Nothing else chooses between them.

Layout ``[B, S, H, D]`` at the public functions, as in the JAX package;
the kernels take each tensor's strides (unit ``D`` stride), so nothing is
moved to ``[B*H, S, D]`` and the key mask ``[B, S]`` is not repeated per
head. Any ``S`` runs as it is: the JAX package's pad to a multiple of 128
was a TPU tiling fact, so a fully masked row averages V over ``S`` keys
here where the JAX flash path averages over the padded length when
``S > 128`` and ``S % 128 != 0``.

Masked scores take the finite ``-1e30`` (not ``-inf``), so a fully masked
row is a uniform softmax on every path, and its lse rounds to ``-1e30``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._counts import count_launch

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 128


# -- the plain versions ---------------------------------------------------

def flash_attention_with_lse_plain(q, k, v, mask=None, causal: bool = False,
                                   scale: float = None):
    """Masked softmax attention with the scores, the softmax and the
    value product in f32, hidden scores at ``-1e30``. Returns
    ``(o [B, S, H, D] in q's dtype, lse [B, H, S] f32)``; differentiable
    through autograd."""
    B, S, H, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask[:, None, None, :] != 0, s, _NEG_INF)
    if causal:
        tril = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(tril[None, None], s, _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse


def flash_attention_plain(q, k, v, mask=None, causal: bool = False,
                          scale: float = None):
    """:func:`flash_attention_with_lse_plain` without the lse."""
    return flash_attention_with_lse_plain(q, k, v, mask, causal, scale)[0]


# -- argument checks --------------------------------------------------------

def _check_args(q, k, v, mask):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k and v must share one "
                         f"[B, S, H, D] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S = q.shape[:2]
    if mask is not None and tuple(mask.shape) != (B, S):
        raise ValueError(f"flash_attention: mask must be [B, S] = "
                         f"{(B, S)}, got {tuple(mask.shape)}")
    devs = {t.device for t in (q, k, v) + ((mask,) if mask is not None
                                           else ())}
    if len(devs) != 1:
        raise ValueError(f"flash_attention: tensors on several devices "
                         f"{sorted(map(str, devs))}")


def _check_kernel_args(q, k, v):
    """What the CUDA kernels take: f32 or bf16 of one dtype, D a multiple
    of 8 up to 128, a unit D stride."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: the kernel takes float32 or "
                        f"bfloat16 q/k/v of one dtype, got {q.dtype}/"
                        f"{k.dtype}/{v.dtype}")
    D = q.shape[-1]
    if D % 8 or not 0 < D <= _MAX_D:
        raise ValueError(f"flash_attention: the kernel takes a head dim "
                         f"that is a multiple of 8 up to {_MAX_D}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} must have a unit "
                             f"head-dim stride, got {t.stride()}")


def _mask_arg(mask):
    """The key mask as the kernels read it: contiguous int32 [B, S]."""
    if mask is None:
        return None
    return mask.to(torch.int32).contiguous()


def _strides(*ts):
    vals = [x for t in ts for x in (t.stride(0), t.stride(1), t.stride(2))]
    return (ctypes.c_longlong * len(vals))(*vals)


def _scale(D, scale):
    return D ** -0.5 if scale is None else float(scale)


# -- kernel launches --------------------------------------------------------

_fns = {}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _kernel(lib_name: str, fn_name: str, n_ptrs: int):
    fn = _fns.get(fn_name)
    if fn is None:
        lib = _build.load(lib_name)
        f = getattr(lib, fn_name)
        f.argtypes = [_P] * n_ptrs + [_I] * 4 + [_P, _F, _I, _I, _P]
        f.restype = _I
        fn = _fns[fn_name] = (lib, f)
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _flash_fwd(q, k, v, mask, causal, scale):
    """One launch of the forward kernel on CUDA tensors: ``(o, lse)``
    with o ``[B, S, H, D]`` contiguous in q's dtype and lse ``[B, H, S]``
    f32. q, k and v must pass :func:`_aligned`."""
    B, S, H, D = q.shape
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib, fn = _kernel("flash_attention_fwd", "flash_attention_fwd", 6)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
                o.data_ptr(), lse.data_ptr(), B, S, H, D,
                _strides(q, k, v, o), _scale(D, scale), int(causal),
                _DTYPES[q.dtype],
                stream)
    _build.check(lib, status, "flash_attention_fwd")
    count_launch(_flash_fwd, stream)
    return o, lse


def _flash_bwd_dq(q, k, v, g, o, lse, g_lse, mask, causal, scale):
    """One launch of the dq kernel: ``(dq, delta)`` with dq ``[B, S, H,
    D]`` in q's dtype and ``delta = rowsum(o * g) - g_lse`` ``[B, H, S]``
    f32 (``g_lse`` may be None), which the kernel's prologue computes for
    the dk/dv kernel. q, k, v, g and o must pass :func:`_aligned`."""
    B, S, H, D = q.shape
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib, fn = _kernel("flash_attention_bwd", "flash_attention_bwd_dq", 10)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                o.data_ptr(), lse.data_ptr(), _ptr(g_lse), _ptr(mask),
                delta.data_ptr(), dq.data_ptr(), B, S, H, D,
                _strides(q, k, v, g, o, dq, dq), _scale(D, scale),
                int(causal), _DTYPES[q.dtype],
                stream)
    _build.check(lib, status, "flash_attention_bwd_dq")
    count_launch(_flash_bwd_dq, stream)
    return dq, delta


def _flash_bwd_dkv(q, k, v, g, lse, delta, mask, causal, scale):
    """One launch of the dk/dv kernel: ``(dk, dv)`` in k's and v's
    dtype, from the ``delta`` the dq kernel wrote."""
    B, S, H, D = q.shape
    dk = torch.empty((B, S, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, S, H, D), dtype=v.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib, fn = _kernel("flash_attention_bwd", "flash_attention_bwd_dkv", 9)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), _ptr(mask), dk.data_ptr(),
                dv.data_ptr(), B, S, H, D,
                _strides(q, k, v, g, dk, dk, dv), _scale(D, scale),
                int(causal), _DTYPES[q.dtype],
                stream)
    _build.check(lib, status, "flash_attention_bwd_dkv")
    count_launch(_flash_bwd_dkv, stream)
    return dk, dv


#: kernel launches since the count was last set to 0 (plain calls on CPU
#: tensors do not count)
_flash_fwd.launches = 0
_flash_bwd_dq.launches = 0
_flash_bwd_dkv.launches = 0
_flash_fwd.library = "flash_attention_fwd"
_flash_bwd_dq.library = _flash_bwd_dkv.library = "flash_attention_bwd"


def _aligned(t):
    """``t`` itself when its base and its B, S and H steps are multiples
    of 16 bytes and its D stride is 1, as the kernels' 16-byte
    ``cp.async`` copies need; else a contiguous copy of it, made here and
    fed to the kernels (a fresh allocation is 16-byte aligned, and a row
    of D % 8 == 0 elements is a multiple of 16 bytes)."""
    es = t.element_size()
    if (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(t.stride(i) * es % 16 == 0 for i in range(3))):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _flash_bwd(q, k, v, mask, o, lse, g, causal, scale, g_lse=None):
    """Both backward kernels: dq first, whose prologue computes ``delta =
    rowsum(o * g)`` (the JAX package leaves it to XLA) with an lse
    cotangent folded in (``delta - g_lse``: d lse / d s = p, so it enters
    ds as ``p * g_lse``), then dk/dv, which reads that delta."""
    q, k, v, g, o = (_aligned(t) for t in (q, k, v, g, o))
    if g_lse is not None:
        g_lse = g_lse.float().contiguous()
    dq, delta = _flash_bwd_dq(q, k, v, g, o, lse, g_lse, mask, causal,
                              scale)
    dk, dv = _flash_bwd_dkv(q, k, v, g, lse, delta, mask, causal, scale)
    return dq, dk, dv


# -- autograd ---------------------------------------------------------------

class _Flash(torch.autograd.Function):
    """o only (the Pallas ``_flash`` / ``_flash_masked`` custom_vjps)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale):
        # the aligned tensors are saved, so the backward copies nothing
        q, k, v = (_aligned(t) for t in (q, k, v))
        o, lse = _flash_fwd(q, k, v, mask, causal, scale)
        # o and lse are saved, never recomputed: under checkpointing the
        # re-run forward gives the same tiles in the same order
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, mask, o, lse, g, ctx.causal,
                                ctx.scale)
        return dq, dk, dv, None, None, None


class _FlashLse(torch.autograd.Function):
    """(o, lse), both differentiable (the Pallas ``_flash_lse_masked``)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale):
        q, k, v = (_aligned(t) for t in (q, k, v))
        o, lse = _flash_fwd(q, k, v, mask, causal, scale)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, mask, o, lse = ctx.saved_tensors
        if g is None:
            g = torch.zeros_like(o)
        dq, dk, dv = _flash_bwd(q, k, v, mask, o, lse, g, ctx.causal,
                                ctx.scale, g_lse)
        return dq, dk, dv, None, None, None


# -- public wrappers --------------------------------------------------------

def _use_kernel(q) -> bool:
    """The one flash-vs-plain decision, recorded in the dispatch counters:
    a CUDA tensor takes the kernels, any other the plain version. Only the
    device decides; there is no sequence-length threshold (the JAX
    package's ``DL4J_TPU_FLASH_MIN_SEQ`` was a TPU measurement)."""
    from . import record_attention     # the package imports this module
    if q.is_cuda:
        record_attention("flash")
        return True
    record_attention("plain",
                     f"{q.device.type} tensor (the kernel runs on CUDA)")
    return False


def flash_attention(q, k, v, mask=None, causal: bool = False,
                    scale: float = None):
    """Flash attention over ``[B, S, H, D]``; ``mask`` is an optional
    ``[B, S]`` key validity (nonzero = attend). Differentiable in q, k, v.
    CUDA tensors run the kernels (or raise); CPU tensors take
    :func:`flash_attention_plain`."""
    _check_args(q, k, v, mask)
    if not _use_kernel(q):
        return flash_attention_plain(q, k, v, mask, causal, scale)
    _check_kernel_args(q, k, v)
    return _Flash.apply(q, k, v, _mask_arg(mask), bool(causal), scale)


def flash_attention_with_lse(q, k, v, mask=None, causal: bool = False,
                             scale: float = None):
    """:func:`flash_attention` that also returns the log-sum-exp of the
    scores: ``(o [B, S, H, D], lse [B, H, S] f32)``, both
    differentiable (the lse cotangent folds into the backward's delta)."""
    _check_args(q, k, v, mask)
    if not _use_kernel(q):
        return flash_attention_with_lse_plain(q, k, v, mask, causal, scale)
    _check_kernel_args(q, k, v)
    return _FlashLse.apply(q, k, v, _mask_arg(mask), bool(causal), scale)
