"""Paged-flash decode: attention read straight from the paged KV pool.

Counterpart of ``deeplearning4j_tpu/kernels/paged_flash_decode.py``
(the Pallas kernel ``paged_flash_decode``). On a CUDA tensor the wrapper
launches the hand-written Hopper kernel in ``csrc/paged_flash_decode.cu``
(whose header says what bounds it and how it is laid out); on a CPU
tensor it runs :func:`paged_flash_decode_plain`, the block-table gather
math the kernel replaces. Nothing else chooses between them.

Layouts match the pool (no transposes at the call site)::

  q                [S, Q, H, D]   queries at positions lengths[s]+0..Q-1
  k_pages/v_pages  [N, Bs, H, D]  one layer's slice of the block pool
  tables           [S, MB] int32  per-slot block table (0 = scratch)
  lengths          [S]     int32  committed rows per slot

Key row ``r`` of a slot is visible to query row ``qi`` iff
``r <= lengths[s] + qi``. ``k_pages``/``v_pages`` may be the strided
per-layer view ``pool[:, i]``: the kernel takes its strides, so the
layer's pool is never copied.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._counts import count_launch

#: the finfo.min mask of the gather path (causal_lm.py's _BIG_NEG)
_BIG_NEG = torch.finfo(torch.float32).min
#: the kernel's finite mask value (the Pallas kernel's)
_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_Q = 16
_MAX_D = 256


def paged_flash_decode_plain(q, k_pages, v_pages, tables, lengths,
                             scale: float = None):
    """The block-table gather read: gather each slot's blocks into a
    contiguous ``[S, MB*Bs, H, D]`` view and run masked softmax attention
    over it, scores and softmax in f32, probabilities cast to ``q``'s
    dtype for the value product (the JAX ``paged_decode`` gather branch).
    Returns ``ctx [S, Q, H, D]`` in ``q.dtype``."""
    S, Q, H, D = q.shape
    MB = tables.shape[1]
    Bs = k_pages.shape[1]
    C = MB * Bs
    scale = D ** -0.5 if scale is None else scale
    idx = tables.long()
    ks = k_pages[idx].reshape(S, C, H, D)
    vs = v_pages[idx].reshape(S, C, H, D)
    att = torch.einsum("sqhd,schd->shqc", q.float(), ks.float()) * scale
    pos = lengths.long()[:, None] + torch.arange(Q, device=q.device)[None]
    key_mask = (torch.arange(C, device=q.device)[None, None, :]
                <= pos[:, :, None])                          # [S, Q, C]
    att = torch.where(key_mask[:, None], att, _BIG_NEG)
    probs = torch.softmax(att, dim=-1).to(q.dtype)
    return torch.einsum("shqc,schd->sqhd", probs, vs)


def paged_flash_decode_split_plain(q, k_pages, v_pages, tables, lengths,
                                   split_rows: int, scale: float = None):
    """The kernel's split-and-merge written out in PyTorch, for the tests
    (the main path never calls it): the table's ``MB*Bs`` rows are cut
    into splits of ``split_rows``; each split keeps its own ``m`` (max
    visible score, -1e30 when it sees none), ``l`` and f32 ``acc``
    (``p`` is 0 on every hidden row), and the splits merge with the
    log-sum-exp rescale, divided by ``max(l, 1e-30)``. Returns ``ctx [S,
    Q, H, D]`` in ``q.dtype``."""
    S, Q, H, D = q.shape
    MB = tables.shape[1]
    Bs = k_pages.shape[1]
    C = MB * Bs
    scale = D ** -0.5 if scale is None else scale
    idx = tables.long()
    ks = k_pages[idx].reshape(S, C, H, D).float()
    vs = v_pages[idx].reshape(S, C, H, D).float()
    pos = lengths.long().clamp_min(0)[:, None] \
        + torch.arange(Q, device=q.device)[None]
    visible = (torch.arange(C, device=q.device)[None, None, :]
               <= pos[:, :, None])[:, None]                  # [S, 1, Q, C]
    att = torch.einsum("sqhd,schd->shqc", q.float() * scale, ks)
    ms, ls, accs = [], [], []
    for r0 in range(0, C, split_rows):
        a = att[..., r0:r0 + split_rows]
        vis = visible[..., r0:r0 + split_rows]
        m = torch.where(vis, a, _NEG_INF).amax(-1)           # [S, H, Q]
        p = torch.where(vis, torch.exp(a - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("shqc,schd->shqd", p,
                                 vs[:, r0:r0 + split_rows]))
    m_all = torch.stack(ms)                                  # [n, S, H, Q]
    mx = m_all.amax(0)
    f = torch.exp(m_all - mx)
    lsum = (torch.stack(ls) * f).sum(0)
    acc = (torch.stack(accs) * f[..., None]).sum(0)
    ctx = acc / torch.clamp_min(lsum, 1e-30)[..., None]     # [S, H, Q, D]
    return ctx.permute(0, 2, 1, 3).to(q.dtype)


def _check_args(q, k_pages, v_pages, tables, lengths):
    if q.dim() != 4 or k_pages.dim() != 4 or v_pages.dim() != 4:
        raise ValueError("paged_flash_decode: q [S,Q,H,D] and k/v pages "
                         "[N,Bs,H,D] must be 4-D")
    S, Q, H, D = q.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[2:] != (H, D):
        raise ValueError(f"paged_flash_decode: page shapes {k_pages.shape} "
                         f"/ {v_pages.shape} do not match q {q.shape}")
    if tables.dim() != 2 or tables.shape[0] != S or lengths.shape != (S,):
        raise ValueError(f"paged_flash_decode: tables {tables.shape} / "
                         f"lengths {lengths.shape} do not match S={S}")
    devs = {t.device for t in (q, k_pages, v_pages, tables, lengths)}
    if len(devs) != 1:
        raise ValueError(f"paged_flash_decode: tensors on several devices "
                         f"{sorted(map(str, devs))}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_flash_decode: the kernel takes float32 or "
                        f"bfloat16 q/k/v of one dtype, got {q.dtype}/"
                        f"{k_pages.dtype}/{v_pages.dtype}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_flash_decode: tables and lengths must be "
                        "int32")
    if Q > _MAX_Q or D > _MAX_D:
        raise ValueError(f"paged_flash_decode: the kernel takes Q <= "
                         f"{_MAX_Q} and D <= {_MAX_D}, got Q={Q} D={D}")
    if not q.is_contiguous() or not tables.is_contiguous() \
            or not lengths.is_contiguous():
        raise ValueError("paged_flash_decode: q, tables and lengths must "
                         "be contiguous")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.stride(3) != 1:
            raise ValueError(f"paged_flash_decode: {name} must have a "
                             f"unit head_dim stride, got {t.stride()}")


def _check_kernel_layout(q, k_pages, v_pages):
    """What the CUDA kernel needs beyond :func:`_check_args`: rows of D
    that are whole 16-byte chunks, and 16-byte aligned pointers and
    strides (true of every pool slice with such a D)."""
    D = q.shape[3]
    per = 16 // q.element_size()
    if D % per:
        raise ValueError(f"paged_flash_decode: the kernel reads rows in "
                         f"16-byte chunks: D={D} must be a multiple of "
                         f"{per} for {q.dtype}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16 or any(st % per for st in t.stride()[:3]):
            raise ValueError(f"paged_flash_decode: {name} must be 16-byte "
                             f"aligned in its pointer and strides, got "
                             f"strides {t.stride()}")


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("paged_flash_decode")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.paged_flash_decode.argtypes = (
            [P] * 8 + [I] * 7 + [L] * 6 + [ctypes.c_float, I, P])
        lib.paged_flash_decode.restype = I
        lib.paged_flash_decode_workspace_bytes.argtypes = [I] * 6
        lib.paged_flash_decode_workspace_bytes.restype = L
        lib.paged_flash_decode_split_rows.restype = I
        _lib = lib
    return _lib


def split_rows() -> int:
    """Table rows each block of the kernel covers (its split size)."""
    return _kernel().paged_flash_decode_split_rows()


def _launch(q, k_pages, v_pages, tables, lengths, scale):
    """One launch of the split kernel (its merge included) into a new
    ``ctx``. The split workspace comes from ``torch.empty`` and the merge
    counters from :func:`_build.counters`, both sized from host shapes."""
    S, Q, H, D = q.shape
    N, Bs = k_pages.shape[:2]
    MB = tables.shape[1]
    out = torch.empty_like(q)
    lib = _kernel()
    nbytes = lib.paged_flash_decode_workspace_bytes(S, Q, H, D, Bs, MB)
    ws = torch.empty((nbytes + 3) // 4, dtype=torch.float32,
                     device=q.device) if nbytes > 0 else None
    cnt = _build.counters(q.device, S * H * Q)
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, cnt.data_ptr(),
            S, Q, H, D, Bs, MB, N,
            k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
            v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
            scale, _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    status = lib.paged_flash_decode(*args)
    _build.check(lib, status, "paged_flash_decode")
    return out


def paged_flash_decode(q, k_pages, v_pages, tables, lengths,
                       scale: float = None):
    """Attention context for the paged decode step, read from the block
    pool: ``ctx [S, Q, H, D]`` in ``q.dtype``. The K/V pages must already
    hold the step's own rows (callers scatter them through the block
    table first). CUDA tensors launch the kernel (or raise); CPU tensors
    take :func:`paged_flash_decode_plain`."""
    _check_args(q, k_pages, v_pages, tables, lengths)
    if not q.is_cuda:
        return paged_flash_decode_plain(q, k_pages, v_pages, tables,
                                        lengths, scale)
    _check_kernel_layout(q, k_pages, v_pages)
    D = q.shape[3]
    scale = D ** -0.5 if scale is None else float(scale)
    out = _launch(q, k_pages, v_pages, tables, lengths, scale)
    count_launch(paged_flash_decode)
    return out


#: kernel launches since the count was last set to 0 (plain calls on CPU
#: tensors do not count)
paged_flash_decode.launches = 0
