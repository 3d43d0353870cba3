"""Forward-mode dual numbers over tensors.

The plain versions of the kernels that differentiate (the tangent transport
of the float32 manifold target, the float32 Jacobian ``shoot_jvp``) carry
each quantity as ``Dual(v, d)``: a value and its derivative along one or
more directions.  ``d`` broadcasts against ``v`` with leading dimensions of
its own (one per direction), and a ``Dual`` of ``Dual`` s is a nested dual:
a derivative of a derivative.  The CUDA kernels use the same construction
(``csrc/cr3bp_shoot.cu``: ``Dual<T>``).  ``torch.func`` and
``torch.autograd.forward_ad`` compute the same derivatives, but on the CPU at
the solver's tensor sizes their per-operation cost is tens of times that of
the plain operations below.

The vector fields they run through are ``cr3bp.eom_c`` and
``manifold.ode6_c``, which take and return tuples of components (tensors or
duals): the same expressions as the tensor paths.
"""
from __future__ import annotations

import torch


class Dual:
    """``v + d eps`` with eps^2 = 0; v and d are tensors or duals."""

    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v, self.d = v, d

    def __add__(a, b):
        if isinstance(b, Dual):
            return Dual(a.v + b.v, a.d + b.d)
        return Dual(a.v + b, a.d)

    __radd__ = __add__

    def __sub__(a, b):
        if isinstance(b, Dual):
            return Dual(a.v - b.v, a.d - b.d)
        return Dual(a.v - b, a.d)

    def __rsub__(a, b):
        return Dual(b - a.v, -a.d)

    def __neg__(a):
        return Dual(-a.v, -a.d)

    def __mul__(a, b):
        if isinstance(b, Dual):
            return Dual(a.v * b.v, a.v * b.d + a.d * b.v)
        return Dual(a.v * b, a.d * b)

    __rmul__ = __mul__

    def __truediv__(a, b):
        if isinstance(b, Dual):
            q = a.v / b.v
            return Dual(q, (a.d - q * b.d) / b.v)
        return Dual(a.v / b, a.d / b)

    def __rtruediv__(a, b):
        q = b / a.v
        return Dual(q, -(q * a.d) / a.v)

    def __pow__(a, n: int):
        return Dual(a.v ** n, (n * a.v ** (n - 1)) * a.d)

    def sqrt(a):
        s = a.v.sqrt()
        return Dual(s, a.d * (0.5 / s))

    def sin(a):
        return Dual(a.v.sin(), a.d * a.v.cos())

    def cos(a):
        return Dual(a.v.cos(), -(a.d * a.v.sin()))

    def clamp(a, min):
        """max(a, min) with ``jnp.maximum``'s derivative (half at a tie)."""
        return Dual(a.v.clamp(min=min), a.d * max_d(value(a), min))


def value(x):
    """The innermost value of a (possibly nested) dual."""
    while isinstance(x, Dual):
        x = x.v
    return x


def rk4_c(f, s, dt):
    """One RK4 step of the field ``f`` on a tuple of components."""
    k1 = f(s)
    k2 = f(tuple(a + 0.5 * dt * b for a, b in zip(s, k1)))
    k3 = f(tuple(a + 0.5 * dt * b for a, b in zip(s, k2)))
    k4 = f(tuple(a + dt * b for a, b in zip(s, k3)))
    return tuple(a + (dt / 6.0) * (b1 + 2 * b2 + 2 * b3 + b4)
                 for a, b1, b2, b3, b4 in zip(s, k1, k2, k3, k4))


def clip_d(x, lo, hi):
    """d clip(x, lo, hi) / dx as the JAX package's ``jnp.clip`` has it: 1
    inside, 1/2 on a bound, 0 outside."""
    inside = ((x > lo) & (x < hi)).to(x.dtype)
    return torch.where((x == lo) | (x == hi), 0.5, inside).to(x.dtype)


def max_d(x, c):
    """d max(x, c) / dx: 1 above c, 1/2 at c, 0 below (``jnp.maximum``)."""
    return torch.where(x == c, 0.5, (x > c).to(x.dtype)).to(x.dtype)
