"""Matrix-free Levenberg-Marquardt over block-sparse Jacobians.

The rig and the pose-prior bundle adjusters of the JAX package
(estimators/rig_bundle_adjustment.py, estimators/pose_prior_ba.py) run a
fixed number of LM iterations, each solving (J^T J + lam I) delta = -J^T r
with jax.scipy.sparse.linalg.cg (tolerance 1e-5 relative to ||b||, no
absolute tolerance, no preconditioner, `maxiter` steps at most), where J v
and J^T u come from jvp / vjp through the residual. This module computes
the same iteration without forward-mode autodiff:

  * J is kept as per-row blocks, formed once per LM iteration by the
    caller (torch.func.vmap of torch.func.jacrev over one observation's
    residual): a `Term` holds the rows' Jacobian with respect to one
    parameter block and the block entry each row reads;
  * J v is a gather and a batched matvec per term; J^T u a batched matvec
    and a segment sum (index_add_) per term;
  * CG's stopping rule is a device-side "done" flag that freezes x, r and
    p, so neither loop reads the device from the host;
  * CG may be preconditioned by the block Jacobi inverse (jax's cg with
    M = the inverse of J^T J + lam I's diagonal blocks), which the JAX
    package does not do: the rig adjuster needs it on real captures;
  * accept and reject are torch.where; lambda is multiplied by 0.3 or 5 and
    clamped to [1e-10, 1e6].
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

CG_TOL = 1e-5  # jax.scipy.sparse.linalg.cg's default relative tolerance


class Term(NamedTuple):
    """Rows of one residual group that depend on one parameter block."""

    J: torch.Tensor  # (N, k, d): residual rows (k each) by block dofs (d)
    idx: torch.Tensor  # (N,) int64: the block entry each row reads
    block: int  # which parameter block
    group: int  # which residual group (rows are that group's, in order)


class LMResult(NamedTuple):
    params: tuple  # the parameters after the last iteration
    cost: torch.Tensor  # 0.5 * sum r^2 at them (device scalar)
    lm_iterations: int
    cg_steps: torch.Tensor  # CG steps taken over all iterations (device)
    syncs: int  # device scalars the host read inside the loops (none)


def jvp(terms: Sequence[Term], v: Tuple[torch.Tensor, ...],
        group_shapes) -> list:
    """J v as one (N_g, k_g) tensor per residual group."""
    out = [torch.zeros(s, dtype=v[0].dtype, device=v[0].device)
           for s in group_shapes]
    for t in terms:
        out[t.group] = out[t.group] + torch.einsum(
            "nkd,nd->nk", t.J, v[t.block][t.idx])
    return out


def vjp(terms: Sequence[Term], u, block_shapes) -> tuple:
    """J^T u as one (n_b, d_b) tensor per parameter block."""
    out = [torch.zeros(s, dtype=u[0].dtype, device=u[0].device)
           for s in block_shapes]
    for t in terms:
        out[t.block] = out[t.block].index_add(
            0, t.idx, torch.einsum("nkd,nk->nd", t.J, u[t.group]))
    return tuple(out)


def _dot(a, b) -> torch.Tensor:
    return sum(torch.sum(x * y) for x, y in zip(a, b))


def cg(matvec: Callable, b: tuple, maxiter: int,
       precond: Optional[Callable] = None):
    """jax.scipy.sparse.linalg.cg from x0 = 0: steps while r.r >
    (CG_TOL ||b||)^2, at most `maxiter`, preconditioned by `precond` when
    given. The test is a device flag; a finished solve keeps x, r, p and
    gamma. Returns (x, steps taken as a device int)."""
    M = precond or (lambda v: v)
    atol2 = CG_TOL ** 2 * _dot(b, b)
    x = tuple(torch.zeros_like(bi) for bi in b)
    r = b
    p = M(r)
    gamma = _dot(r, p)
    rs = _dot(r, r)
    steps = torch.zeros((), dtype=torch.int64, device=b[0].device)
    for _ in range(maxiter):
        active = rs > atol2
        Ap = matvec(p)
        alpha = gamma / _dot(p, Ap)
        x_new = tuple(xi + alpha * pi for xi, pi in zip(x, p))
        r_new = tuple(ri - alpha * ai for ri, ai in zip(r, Ap))
        z = M(r_new)
        gamma_new = _dot(r_new, z)
        p_new = tuple(zi + (gamma_new / gamma) * pi for zi, pi in zip(z, p))
        x = tuple(torch.where(active, n, o) for n, o in zip(x_new, x))
        r = tuple(torch.where(active, n, o) for n, o in zip(r_new, r))
        p = tuple(torch.where(active, n, o) for n, o in zip(p_new, p))
        gamma = torch.where(active, gamma_new, gamma)
        rs = torch.where(active, _dot(r, r), rs)
        steps = steps + active.to(torch.int64)
    return x, steps


def jacobi_blocks(terms: Sequence[Term], block_shapes, lam) -> Callable:
    """The inverse of the diagonal blocks of J^T J + lam I (one d x d block
    per parameter-block entry) as a CG preconditioner."""
    diag = [torch.zeros((s[0], s[1], s[1]), dtype=lam.dtype,
                        device=lam.device) for s in block_shapes]
    for t in terms:
        diag[t.block] = diag[t.block].index_add(
            0, t.idx, torch.einsum("nki,nkj->nij", t.J, t.J))
    inv = [torch.linalg.inv_ex(d + lam * torch.eye(
        d.shape[-1], dtype=d.dtype, device=d.device))[0] for d in diag]

    def apply(v):
        return tuple(torch.einsum("nij,nj->ni", m, vi)
                     for m, vi in zip(inv, v))
    return apply


def solve(params: tuple, residuals: Callable, jacobian: Callable,
          retract: Callable, block_shapes, max_iterations: int,
          cg_iterations: int, initial_lambda: float,
          block_jacobi: bool = False) -> LMResult:
    """`max_iterations` LM iterations from `params`; CG is preconditioned
    by the block Jacobi inverse when `block_jacobi` (the JAX package's CG
    has no preconditioner).

    residuals(params) -> list of (N_g, k_g) residual groups;
    jacobian(params) -> list of Terms, frozen dofs' columns zeroed;
    retract(params, delta) -> params updated by the block deltas (frozen
    dofs masked); block_shapes: the (n_b, d_b) shape of each delta block.
    """
    def cost_of(p):
        return 0.5 * sum(torch.sum(g * g) for g in residuals(p))

    cost = cost_of(params)
    lam = torch.tensor(initial_lambda, dtype=cost.dtype, device=cost.device)
    steps = torch.zeros((), dtype=torch.int64, device=cost.device)
    for _ in range(max_iterations):
        r = residuals(params)
        shapes = [g.shape for g in r]
        terms = jacobian(params)
        b = tuple(-g for g in vjp(terms, r, block_shapes))

        def matvec(v):
            return tuple(h + lam * vi for h, vi in zip(
                vjp(terms, jvp(terms, v, shapes), block_shapes), v))

        precond = (jacobi_blocks(terms, block_shapes, lam) if block_jacobi
                   else None)
        delta, k = cg(matvec, b, cg_iterations, precond)
        steps = steps + k
        new = retract(params, delta)
        new_cost = cost_of(new)
        accept = new_cost < cost
        params = tuple(torch.where(accept, n, o) for n, o in zip(new, params))
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-10),
                          torch.clamp(lam * 5.0, max=1e6))
        cost = torch.where(accept, new_cost, cost)
    return LMResult(params=params, cost=cost, lm_iterations=max_iterations,
                    cg_steps=steps, syncs=0)
