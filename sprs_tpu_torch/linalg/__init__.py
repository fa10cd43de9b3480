"""Iterative solvers: BiCGSTAB, CG, Jacobi and Gauss–Seidel."""

from .bicgstab import BiCgStabResult, bicgstab
from .cg import CgResult, cg
from .iterative import IterativeResult, gauss_seidel, jacobi
