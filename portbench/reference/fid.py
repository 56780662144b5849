"""Plain Frechet distance between two Gaussian fits, in the precision of their moments (float64).

``|mu1 - mu2|^2 + tr(S1) + tr(S2) - 2 tr((S1 S2)^(1/2))``; the last trace is the sum of the square roots of
the eigenvalues of ``S1^(1/2) S2 S1^(1/2)``, which has the eigenvalues of ``S1 S2`` and is symmetric.
"""

from typing import Optional

import torch


class Moments:
    """Row count, sum and sum of outer products of feature rows, in ``dtype`` (float64)."""

    def __init__(self, dtype: torch.dtype = torch.float64) -> None:
        self.dtype = dtype
        self.n = 0
        self.total: Optional[torch.Tensor] = None
        self.outer: Optional[torch.Tensor] = None

    def add(self, rows: torch.Tensor) -> None:
        x = rows.to(self.dtype)
        s, o = x.sum(0), x.T @ x
        self.total = s if self.total is None else self.total + s
        self.outer = o if self.outer is None else self.outer + o
        self.n += x.shape[0]

    def copy(self) -> "Moments":
        out = Moments(self.dtype)
        out.n = self.n
        out.total = None if self.total is None else self.total.clone()
        out.outer = None if self.outer is None else self.outer.clone()
        return out

    def mean_cov(self):
        mean = self.total / self.n
        cov = (self.outer - self.n * torch.outer(mean, mean)) / (self.n - 1)
        return mean, cov


def _sqrt_psd(mat: torch.Tensor) -> torch.Tensor:
    vals, vecs = torch.linalg.eigh((mat + mat.T) / 2)
    return (vecs * vals.clamp(min=0).sqrt()) @ vecs.T


def frechet_distance(a: Moments, b: Moments) -> float:
    mu1, s1 = a.mean_cov()
    mu2, s2 = b.mean_cov()
    root = _sqrt_psd(s1)
    inner = root @ s2 @ root
    tr_covmean = torch.linalg.eigvalsh((inner + inner.T) / 2).clamp(min=0).sqrt().sum()
    diff = mu1 - mu2
    return float(diff @ diff + torch.trace(s1) + torch.trace(s2) - 2 * tr_covmean)
