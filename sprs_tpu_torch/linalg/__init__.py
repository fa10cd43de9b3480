"""Iterative and block solvers: BiCGSTAB (dense and sparse iterates),
CG, GMRES, LSQR, Jacobi, Gauss–Seidel, LOBPCG, svds and expm_multiply."""

from .bicgstab import BiCgStabResult, bicgstab, bicgstab_sparse
from .cg import CgResult, cg
from .expm import expm_multiply
from .gmres import GmresResult, gmres
from .iterative import IterativeResult, gauss_seidel, jacobi
from .lobpcg import LobpcgResult, lobpcg
from .lsqr import LsqrResult, lsqr
from .svds import SvdsResult, svds
