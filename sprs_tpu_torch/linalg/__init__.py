"""Iterative and block solvers: BiCGSTAB, CG, Jacobi, Gauss–Seidel,
LOBPCG, svds and expm_multiply."""

from .bicgstab import BiCgStabResult, bicgstab
from .cg import CgResult, cg
from .expm import expm_multiply
from .iterative import IterativeResult, gauss_seidel, jacobi
from .lobpcg import LobpcgResult, lobpcg
from .svds import SvdsResult, svds
