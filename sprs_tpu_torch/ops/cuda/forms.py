"""The operand types that the real products K1 (``dia_spmv``), K2
(``dia_spmm``), K3/K4 (``bsr_spmm``), K5 (``ell_spmv``) and K7
(``csr_spmv``) take on the card, and the rule that K1's, K2's and K5's
plain versions, and the VJPs of K1, K2, K5 and K7, follow for 16-bit
operands (K3's sums are float32 in every form: ``bsr_spmm.py``).  K8
(``krylov.py``) takes two of these types, float32 and float64, named by
:data:`SHORT`.

Every (data, x) pair of float16, bfloat16, float32 and float64 is a form.
As in the Pallas kernels, the output type is ``promote(data, x)``; K1's,
K2's and K5's products and sums run in ``promote(out, float32)``, rounded
once to the output, and (float16, float16) alone rounds each product to
float16 before its float32 sum, as the Pallas kernels' float16 products
do.  Each form
is one C entry point of the kernel's source, named by its suffix here
(``<data>_<x>``, or ``<t>`` where both are ``t``); any other pair (a
complex or an integer operand) raises ``TypeError`` on the card.  Each
wrapper counts its launches by form in ``launches_<suffix>``
(``launch.count``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

SHORT = {torch.float16: "f16", torch.bfloat16: "bf16", torch.float32: "f32", torch.float64: "f64"}
HALVES = (torch.float16, torch.bfloat16)

# (data dtype, x dtype) -> the suffix of the form's entry point
FORMS = {
    (d, x): SHORT[d] if d == x else f"{SHORT[d]}_{SHORT[x]}" for d in SHORT for x in SHORT
}


def form_of(kernel: str, data: torch.Tensor, x: torch.Tensor) -> str:
    """The suffix of the form of (``data``, ``x``); TypeError naming the
    types ``kernel`` takes when it has none."""
    form = FORMS.get((data.dtype, x.dtype))
    if form is None:
        names = ", ".join(str(t).replace("torch.", "") for t in SHORT)
        raise TypeError(
            f"{kernel} kernel takes data and x of the types {names}, got {data.dtype} and {x.dtype}"
        )
    return form


def widened(
    data: torch.Tensor, x: torch.Tensor
) -> Optional[Tuple[torch.dtype, torch.dtype, torch.dtype]]:
    """(out, acc, prod) where ``data`` or ``x`` is 16-bit: a plain version
    takes each product in ``prod`` and adds it in ``acc = promote(out,
    float32)``, rounding once to ``out = promote(data, x)``, as the kernels
    do.  ``prod`` is float16 for (float16, float16), whose products the
    kernels round to float16, and ``acc`` otherwise.  None where neither
    operand is 16-bit: the plain product's own arithmetic is then the
    kernels'."""
    if data.dtype not in HALVES and x.dtype not in HALVES:
        return None
    out = torch.promote_types(data.dtype, x.dtype)
    acc = torch.promote_types(out, torch.float32)
    prod = torch.float16 if data.dtype == x.dtype == torch.float16 else acc
    return out, acc, prod
