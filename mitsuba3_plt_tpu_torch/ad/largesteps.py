"""LargeSteps: Laplacian-preconditioned shape optimization.

The JAX package's `ad/largesteps.py` (after the reference's LargeSteps,
Nicolet et al. 2021, "Large Steps in Inverse Rendering of Geometry"):
optimize u = (I + lambda L) v, so gradient steps stay smooth, and recover
the vertices v by a conjugate-gradient solve of that SPD system with a
matrix-free matvec (`index_add_` over the unique edges).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


def _edges_from_faces(faces) -> np.ndarray:
    f = np.asarray(faces, np.int64)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    return np.unique(np.sort(e, axis=1), axis=0)


@dataclasses.dataclass(frozen=True)
class LargeSteps:
    """Combinatorial-Laplacian preconditioner of a fixed-topology mesh."""

    edges: Any        # [E, 2] int64
    n_vertices: int
    lambda_: float = 19.0

    @staticmethod
    def create(vertices, faces, lambda_: float = 19.0) -> "LargeSteps":
        """The edges of `faces` on the device of `vertices` (a tensor; the
        CPU for an array)."""
        device = (vertices.device if isinstance(vertices, torch.Tensor)
                  else "cpu")
        return LargeSteps(
            edges=torch.as_tensor(_edges_from_faces(faces), device=device),
            n_vertices=len(vertices), lambda_=float(lambda_))

    def _laplacian_matvec(self, x):
        """(I + lambda L) x, L = D - A (uniform weights)."""
        i, j = self.edges[:, 0], self.edges[:, 1]
        diff_ij = x[i] - x[j]
        out = torch.zeros_like(x)
        out.index_add_(0, i, diff_ij)
        out.index_add_(0, j, -diff_ij)
        return x + self.lambda_ * out

    def to_differential(self, v):
        """v -> u = (I + lambda L) v."""
        return self._laplacian_matvec(torch.as_tensor(v, dtype=torch.float32))

    def from_differential(self, u, tol: float = 1e-6, maxiter: int = 200):
        """u -> v: conjugate gradients on the SPD system, from v = 0,
        stopping when |r| <= max(tol |u|, 0) (jax.scipy.sparse.linalg.cg's
        rule with atol 0) or after maxiter steps."""
        b = torch.as_tensor(u, dtype=torch.float32)
        x = torch.zeros_like(b)
        r = b.clone()
        p = r.clone()
        rs = torch.sum(r * r)
        stop = (tol * tol) * torch.sum(b * b)
        for _ in range(maxiter):
            if rs <= stop:
                break
            ap = self._laplacian_matvec(p)
            alpha = rs / torch.sum(p * ap)
            x = x + alpha * p
            r = r - alpha * ap
            rs_new = torch.sum(r * r)
            p = r + (rs_new / rs) * p
            rs = rs_new
        return x
