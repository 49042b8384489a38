"""Differentiable simulation on the card: recover a PDE coefficient by
Newton descent through the TDVP integrator.

The port of ``examples/qtt_fit_coefficient.py``.  The observed data is
the energy series ``E_n = <u_n, A u_n>`` of a heat flow ``du/dt = -c* A
u`` at an unknown diffusion coefficient ``c*``.  ``tdvp_trajectory``
(``ops/evolve.py``) is a pure function of tensors, so ``torch.autograd``
differentiates the misfit

    L(c) = sum_n (E_n(c) - E_n(c*))^2

through every step of the integrator -- the local matrix exponentials,
the QR gauge moves, the loop over steps -- and, with
``create_graph=True``, differentiates the gradient again: the exact
curvature, hence the exact 1D Newton step ``c <- c - L'(c) / L''(c)``
(a fixed step ``sign(L') 0.1`` where the curvature is not positive).
No finite differences: each iteration is one forward, one backward and
one double backward.

The QR pullback needs tall factors, so the state keeps a uniform rank
that does not exceed the mode size: rank 2 on binary modes.  Float64.

    python3 examples_torch/qtt_fit_coefficient.py [--device cpu]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np
import torch

from examples_torch._common import clock, device_of, parser
from tensor_networks_tpu_torch.ops import packed as pk
from tensor_networks_tpu_torch.ops.evolve import tdvp_trajectory
from tensor_networks_tpu_torch.ops.packed import PackedTTOp
from tensor_networks_tpu_torch.ops.qtt import qtt_tridiagonal


def fit_problem(K: int = 8, rank: int = 2, steps: int = 12, dt: float = 0.05,
                c_true: float = 1.3, device=None, seed: int = 0):
    """``(loss, energies)``: functions of the coefficient ``c`` (a float64
    tensor, or a float) on the run's device.  ``energies(c)`` is the
    ``(steps,)`` energy series of the flow under ``c A`` from a random
    full-rank start (``numpy.random.default_rng(seed)``, the JAX
    script's draws); ``loss(c)`` its squared misfit to the series at
    ``c_true``."""
    dev = device_of(device)
    A = qtt_tridiagonal(K, 2.0, -1.0, -1.0, device=dev)
    rng = np.random.default_rng(seed)
    u0 = pk.from_numpy(rng.standard_normal((2, rank)),
                       rng.standard_normal((K - 2, rank, 2, rank)) / np.sqrt(rank),
                       rng.standard_normal((rank, 2)), device=dev)

    def energies(c):
        Ac = PackedTTOp(A.first * c, A.mids, A.last)
        _, _, obs = tdvp_trajectory(Ac, u0, dt, steps, observables=(A,))
        return obs[:, 0]

    with torch.no_grad():
        data = energies(torch.tensor(c_true, dtype=torch.float64, device=dev))

    def loss(c):
        r = energies(c) - data
        return torch.sum(r * r)

    return loss, energies


def newton_parts(loss, c: float, dev) -> dict:
    """One Newton iteration at ``c``: the loss, its gradient
    (``create_graph=True``) and curvature (the gradient's gradient), the
    step and the next ``c``, with each part's wall (forward, backward,
    double backward)."""
    ct = torch.tensor(c, dtype=torch.float64, device=dev, requires_grad=True)
    t0 = clock(dev)
    val = loss(ct)
    t1 = clock(dev)
    (grad,) = torch.autograd.grad(val, ct, create_graph=True)
    t2 = clock(dev)
    (curv,) = torch.autograd.grad(grad, ct)
    t3 = clock(dev)
    val, grad, curv = val.item(), grad.item(), curv.item()
    step = grad / curv if curv > 0 else float(np.sign(grad)) * 0.1
    return {"c": c, "loss": val, "grad": grad, "curv": curv, "c_next": c - step,
            "forward_s": t1 - t0, "backward_s": t2 - t1, "double_backward_s": t3 - t2}


def central_differences(loss, c: float, dev, h: float = 1e-5) -> tuple:
    """(dL/dc, d2L/dc2) at ``c`` by central differences: of the loss, and of
    its first-order autograd gradient."""
    def grad_at(x):
        xt = torch.tensor(x, dtype=torch.float64, device=dev, requires_grad=True)
        return torch.autograd.grad(loss(xt), xt)[0].item()

    with torch.no_grad():
        g = (loss(c + h) - loss(c - h)).item() / (2 * h)
    return g, (grad_at(c + h) - grad_at(c - h)) / (2 * h)


def main(K: int = 8, rank: int = 2, steps: int = 12, dt: float = 0.05,
         c_true: float = 1.3, c_start: float = 0.4, iters: int = 12, device=None) -> dict:
    dev = device_of(device)
    loss, _ = fit_problem(K, rank, steps, dt, c_true, dev)
    c = c_start
    history = []
    print(f"fitting c (true {c_true}) from the energy series of "
          f"{steps} TDVP steps on 2^{K} points, start c={c_start}")
    t0 = clock(dev)
    for it in range(iters):
        part = newton_parts(loss, c, dev)
        history.append(part)
        c = part["c_next"]
        print(f"  it {it}: loss {part['loss']:.3e}  c {c:.10f}  "
              f"(forward {part['forward_s']:.2f}s, backward {part['backward_s']:.2f}s, "
              f"double backward {part['double_backward_s']:.2f}s)")
        if part["loss"] < 1e-22:
            break
    wall = clock(dev) - t0
    err = abs(c - c_true)
    print(f"recovered c = {c:.10f} (|err| {err:.2e}) in {wall:.1f}s")
    assert err < 1e-7, err
    print("OK")
    return {"c": c, "err": err, "iterations": len(history), "wall_s": wall,
            "history": history}


if __name__ == "__main__":
    main(device=parser(__doc__).parse_args().device)
