"""Plain BiCGSTAB (van der Vorst), unpreconditioned, from x = 0, with the
two guards of sprs's ``src/sparse/linalg/bicgstab.rs``:

* hard restart: the true residual b − A·x is computed only when the
  recursive one passes the tolerance; the solve stops only if the true
  one passes too, else it restarts from it (r̂ = p = r);
* soft restart: when the shadow residual r̂ turns (near-)orthogonal to
  the residual, |r̂·r| < ``restart_eps``·‖r̂‖‖r‖, restart with r̂ = p = r.

Departures from ``bicgstab.rs``: dense vectors on the device in place
of ``CsVec``; the operator is any matvec; float64 throughout; where
r̂·v or t·t is at most ``restart_eps`` the step takes α = 0 or ω = 0
(and β = 0) instead of restarting.  At tolerance 0 (the benchmark's
sets) the hard restart never runs, and the guards do not fire on a
well-posed system.

Returns x, the iterations run and the true residual norm ‖b − A·x‖.
The port's CPU tests hold ``linalg.bicgstab`` against it; the cell's
check holds the sets' residuals against its own, and a short set's x
against its x (``traffic/bicgstab_sets.py`` says why)."""

from __future__ import annotations

import torch


def bicgstab(matvec, b: torch.Tensor, tol: float, max_iter: int, restart_eps: float = 1e-30):
    norm = torch.linalg.vector_norm
    x = torch.zeros_like(b)
    r = b.clone()
    threshold = tol * max(float(norm(b)), 1e-300)
    rhat, p = r, r
    rho = torch.dot(rhat, r)
    it = 0
    done = float(norm(r)) <= threshold
    while it < max_iter and not done:
        it += 1
        v = matvec(p)
        rv = torch.dot(rhat, v)
        alpha = rho / rv if abs(float(rv)) > restart_eps else rho * 0.0
        s = r - alpha * v
        t = matvec(s)
        tt = torch.dot(t, t)
        omega = torch.dot(t, s) / tt if float(tt) > restart_eps else tt * 0.0
        x = x + alpha * p + omega * s
        r = s - omega * t
        if float(norm(r)) <= threshold:  # hard restart
            r = b - matvec(x)
            done = float(norm(r)) <= threshold
            rhat, p, rho = r, r, torch.dot(r, r)
            continue
        rho_new = torch.dot(rhat, r)
        if abs(float(rho_new)) < restart_eps * max(float(norm(r) * norm(rhat)), 1e-300):
            rhat, p, rho = r, r, torch.dot(r, r)  # soft restart
            continue
        if float(omega) == 0.0 or abs(float(rv)) <= restart_eps:
            beta = rho * 0.0
        else:
            beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        rho = rho_new
    return x, it, float(norm(b - matvec(x)))
