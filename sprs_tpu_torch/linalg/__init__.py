"""Solvers: triangular solves, LDLᵀ (simplicial and panel numerics) and
LU factorizations, incomplete factorizations, orderings and the host
symbolic layer, mixed-precision refinement, the differentiable
``solve``, and the iterative and block solvers (BiCGSTAB, CG, GMRES,
LSQR, Jacobi, Gauss–Seidel, LOBPCG, svds, expm_multiply)."""

from .amd import camd_order
from .bicgstab import BiCgStabResult, bicgstab, bicgstab_sparse
from .cg import CgResult, cg
from .etree import etree_from_pattern, postorder, tree_levels
from .expm import expm_multiply
from .gmres import GmresResult, gmres
from .ilu import Ic0, Ilu0, ic0, ilu0
from .iterative import IterativeResult, gauss_seidel, jacobi
from .ldl import FILL_CAMD, FILL_ND, FILL_NONE, FILL_RCM, Ldl, LdlNumeric, LdlSymbolic
from .ldl_mf import MfPlan, build_mf_plan, numeric_multifrontal
from .ldl_super import (
    SupernodalPlanError,
    SuperPlan,
    build_super_plan,
    numeric_supernodal,
    panels_from_csc,
    solve_supernodal,
)
from .lobpcg import LobpcgResult, lobpcg
from .lsqr import LsqrResult, lsqr
from .lu import SpLu, splu
from .nd import nd_order
from .ordering import (
    OrderingResult,
    bandwidth,
    cuthill_mckee,
    cuthill_mckee_custom,
    reverse_cuthill_mckee,
)
from .refine import refine_solve
from .solve import solve
from .supernodes import (
    Supernodes,
    amalgamate,
    amalgamate_subtree,
    amalgamate_union,
    fundamental_supernodes,
    supernode_structure,
)
from .svds import SvdsResult, svds
from .trisolve import (
    FlatTriSchedule,
    TriSchedule,
    build_flat_schedule,
    build_schedule,
    diag_solve,
    lsolve,
    lsolve_csc_sparse_rhs,
    usolve,
)
