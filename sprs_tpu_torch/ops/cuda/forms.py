"""The operand types that the real products K1 (``dia_spmv``), K2
(``dia_spmm``) and K5 (``ell_spmv``) take on the card, and the rule their
plain versions follow for bfloat16.

As in the Pallas kernels, the output type is ``promote(data, x)`` and the
products and sums run in ``promote(out, float32)``, rounded once to the
output.  Each form is one C entry point of the kernel's source, named by
its suffix here; any other pair raises ``TypeError`` on the card.  Each
wrapper counts its launches by form in ``launches_<suffix>``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# (data dtype, x dtype) -> the suffix of the form's entry point
FORMS = {
    (torch.float32, torch.float32): "f32",
    (torch.float64, torch.float64): "f64",
    (torch.bfloat16, torch.bfloat16): "bf16",
    (torch.bfloat16, torch.float32): "bf16_f32",
}


def form_of(kernel: str, data: torch.Tensor, x: torch.Tensor) -> str:
    """The suffix of the form of (``data``, ``x``); TypeError naming the
    forms ``kernel`` takes when it has none."""
    form = FORMS.get((data.dtype, x.dtype))
    if form is None:
        names = ", ".join(f"({d}, {v})".replace("torch.", "") for d, v in FORMS)
        raise TypeError(
            f"{kernel} kernel takes (data, x) of types {names}, got {data.dtype} and {x.dtype}"
        )
    return form


def count_launch(wrapper, form: str) -> None:
    wrapper.launches += 1
    name = f"launches_{form}"
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def zero_counts(wrapper) -> None:
    """Set ``wrapper.launches`` and each form's count to 0."""
    wrapper.launches = 0
    for form in FORMS.values():
        setattr(wrapper, f"launches_{form}", 0)


def widened(data: torch.Tensor, x: torch.Tensor) -> Optional[Tuple[torch.dtype, torch.dtype]]:
    """(out, acc) where ``data`` or ``x`` is bfloat16: a plain version
    widens both to ``acc = promote(out, float32)`` and rounds once to
    ``out = promote(data, x)``, as the kernels do.  None otherwise: the
    plain product's own arithmetic is then the kernels'."""
    if torch.bfloat16 not in (data.dtype, x.dtype):
        return None
    out = torch.promote_types(data.dtype, x.dtype)
    return out, torch.promote_types(out, torch.float32)
