"""``nd.linalg``: MXNet's linear-algebra operators (counterpart of
``incubator_mxnet_tpu/ndarray/linalg.py``; MXNet's ``la_op.cc``).

Each operator batches over the leading axes and runs on ``torch.linalg``
(cuBLAS and cuSOLVER on the card), as the JAX package leaves them to XLA.
Factorisations keep the reference's conventions: ``gelqf`` is the LQ of a
QR of the transpose, ``svd`` returns ``(u, s, vh)`` of the thin SVD and
``syevd`` ``(U, L)`` with the eigenvectors in U's rows, eigenvalues
ascending. Their signs are LAPACK's (cuSOLVER's on the card): compare
reconstructions, not raw vectors.

Two departures, each MXNet's behaviour where the JAX package's differs
(``ROADMAP.md`` §3): ``trsm`` and ``trmm`` read only the triangle of ``A``
that ``lower`` names, on either side (the JAX package's ``trsm`` with
``rightside=True`` solves with the other triangle, and its ``trmm`` uses all
of ``A``); and ``gemm``/``gemm2`` honour ``axis=``, the axis of the matrix
rows (the JAX package ignores it).
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from .ndarray import _apply

__all__ = ["gemm", "gemm2", "potrf", "potri", "trsm", "trmm", "syrk",
           "gelqf", "sumlogdiag", "extractdiag", "makediag", "inverse",
           "det", "slogdet", "svd", "syevd", "extracttrian", "maketrian"]


def _t(x):
    return x.transpose(-1, -2)


def _rows_at(axis, fn):
    """``fn`` on matrices whose rows lie on ``axis`` (MXNet's ``axis=``):
    that axis is swapped with the second-to-last one around ``fn``."""
    def run(*xs):
        ax = axis % xs[0].dim()
        if ax == xs[0].dim() - 2:
            return fn(*xs)
        return fn(*(x.transpose(ax, -2) for x in xs)).transpose(ax, -2)
    return run


def gemm(A, B, C, alpha=1.0, beta=1.0, transpose_a=False, transpose_b=False,
         axis=-2):
    """``alpha * op(A) @ op(B) + beta * C``."""
    def fn(a, b, c):
        aa = _t(a) if transpose_a else a
        bb = _t(b) if transpose_b else b
        return alpha * torch.matmul(aa, bb) + beta * c
    return _apply(_rows_at(axis, fn), A, B, C)


def gemm2(A, B, alpha=1.0, transpose_a=False, transpose_b=False, axis=-2):
    """``alpha * op(A) @ op(B)``."""
    def fn(a, b):
        aa = _t(a) if transpose_a else a
        bb = _t(b) if transpose_b else b
        return alpha * torch.matmul(aa, bb)
    return _apply(_rows_at(axis, fn), A, B)


def potrf(A, lower=True):
    """The Cholesky factor: L with ``A = L Lᵀ``, or its transpose."""
    def fn(a):
        factor = torch.linalg.cholesky(a)
        return factor if lower else _t(factor)
    return _apply(fn, A)


def potri(A, lower=True):
    """The inverse of the matrix whose Cholesky factor is ``A``: of
    ``A Aᵀ`` for a lower factor, of ``Aᵀ A`` for an upper one."""
    def fn(a):
        b = torch.matmul(a, _t(a)) if lower else torch.matmul(_t(a), a)
        return torch.linalg.inv(b)
    return _apply(fn, A)


def _triangle(a, lower):
    return torch.tril(a) if lower else torch.triu(a)


def trsm(A, B, alpha=1.0, transpose=False, rightside=False, lower=True):
    """X with ``op(A) X = alpha B`` (``X op(A) = alpha B`` on the right
    side), ``A`` triangular (the triangle ``lower`` names)."""
    def fn(a, b):
        aa = _triangle(a, lower)
        upper = not lower
        if transpose:
            aa, upper = _t(aa), lower
        x = torch.linalg.solve_triangular(aa, b, upper=upper,
                                          left=not rightside)
        return alpha * x
    return _apply(fn, A, B)


def trmm(A, B, alpha=1.0, transpose=False, rightside=False, lower=True):
    """``alpha op(A) B`` (``alpha B op(A)`` on the right side), ``A``
    triangular (the triangle ``lower`` names)."""
    def fn(a, b):
        aa = _triangle(a, lower)
        aa = _t(aa) if transpose else aa
        return alpha * (torch.matmul(b, aa) if rightside
                        else torch.matmul(aa, b))
    return _apply(fn, A, B)


def syrk(A, alpha=1.0, transpose=False):
    """``alpha op(A) op(A)ᵀ``."""
    def fn(a):
        aa = _t(a) if transpose else a
        return alpha * torch.matmul(aa, _t(aa))
    return _apply(fn, A)


def gelqf(A):
    """(L, Q) with ``A = L Q``, Q's rows orthonormal: the QR of ``Aᵀ``,
    transposed."""
    def fn(a):
        q, r = torch.linalg.qr(_t(a))
        return _t(r), _t(q)
    return _apply(fn, A)


def sumlogdiag(A):
    return _apply(lambda a: torch.log(torch.diagonal(
        a, dim1=-2, dim2=-1)).sum(-1), A)


def extractdiag(A, offset=0):
    return _apply(lambda a: torch.diagonal(a, offset, dim1=-2, dim2=-1), A)


def makediag(A, offset=0):
    return _apply(lambda a: torch.diag_embed(a, offset), A)


def inverse(A):
    return _apply(torch.linalg.inv, A)


def det(A):
    return _apply(torch.linalg.det, A)


def slogdet(A):
    return _apply(lambda a: tuple(torch.linalg.slogdet(a)), A)


def svd(A):
    """(u, s, vh) of the thin SVD, the reference's order."""
    return _apply(lambda a: tuple(torch.linalg.svd(a, full_matrices=False)),
                  A)


def syevd(A):
    """(U, L) of a symmetric matrix: ``A = Uᵀ diag(L) U``."""
    def fn(a):
        w, v = torch.linalg.eigh(a)
        return _t(v), w
    return _apply(fn, A)


def _tri_indices(n, offset, lower):
    """MXNet's triangle: offset > 0 the upper one, offset < 0 the lower
    one, ``lower`` deciding at offset 0."""
    side = offset < 0 if offset else lower
    return (onp.tril_indices(n, offset) if side
            else onp.triu_indices(n, offset))


def extracttrian(A, offset=0, lower=True):
    """The triangle of a square matrix, packed row by row."""
    i0, i1 = _tri_indices(A.shape[-1], offset, lower)

    def fn(a):
        return a[..., torch.as_tensor(i0, device=a.device),
                 torch.as_tensor(i1, device=a.device)]
    return _apply(fn, A)


def maketrian(A, offset=0, lower=True):
    """The inverse of ``extracttrian``: the packed triangle into a square
    matrix of zeros."""
    k = A.shape[-1]
    # a packed n × n triangle at |offset| o holds (n - o)(n - o + 1) / 2
    n = (math.isqrt(8 * k + 1) - 1) // 2 + abs(offset)
    i0, i1 = _tri_indices(n, offset, lower)

    def fn(a):
        out = a.new_zeros(a.shape[:-1] + (n, n))
        out[..., torch.as_tensor(i0, device=a.device),
            torch.as_tensor(i1, device=a.device)] = a
        return out
    return _apply(fn, A)
