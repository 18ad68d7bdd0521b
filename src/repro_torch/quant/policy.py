"""Precision policies: which layer roles run on which matmul backend.

The port of :mod:`repro.quant.policy`. A :class:`PrecisionPolicy` is passed
anywhere the models accept ``backend=`` (it duck-types through
``backend_for``; see :func:`repro_torch.models.layers.role_backend`). Each
GEMM site of the model declares a *role*, and the policy maps roles to
backend names of :mod:`repro_torch.kernels.ops`:

==============  ============================================================
role            GEMM sites
==============  ============================================================
``attn_qkv``    attention Q/K/V projections
``attn_out``    attention output projection
``mlp``         dense MLP up/gate/down projections
``moe``         the routed experts' three grouped GEMMs (per-group scales
                when quantized) and the shared-expert MLP
``router``      MoE router logits (routing stays accuracy-critical)
``mixer``       mamba / xLSTM in/out projections
==============  ============================================================

Unlisted roles fall through to ``default`` (``None``: the device's default
full-precision backend). Logits, norms and softmaxes never go through the
registry. The backend value ``"q8"`` is resolved by
:func:`repro_torch.kernels.ops.resolve_backend` from the tensors' device
(``cuda_q8`` on the card, ``torch_q8`` on the CPU), not by probing, so one
policy object serves both.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

__all__ = ["PrecisionPolicy", "mlp_q8_policy", "ROLES"]

ROLES = ("attn_qkv", "attn_out", "mlp", "moe", "router", "mixer")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Role -> backend mapping. ``None`` means the device's default backend.

    ``requant`` maps a role to a calibrated per-tensor scale: that role's
    hidden GEMM then writes its output on the int8 grid of the scale (a
    ``requant_int8`` epilogue step) and the next quantized GEMM consumes it
    with no dequantize / re-quantize round trip."""

    rules: Mapping[str, Optional[str]] = dataclasses.field(default_factory=dict)
    default: Optional[str] = None
    name: str = "policy"
    requant: Mapping[str, float] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        unknown = set(self.rules) - set(ROLES)
        if unknown:
            raise ValueError(
                f"policy {self.name!r}: unknown roles {sorted(unknown)}; "
                f"known: {list(ROLES)}"
            )
        unknown_rq = set(self.requant) - set(ROLES)
        if unknown_rq:
            raise ValueError(
                f"policy {self.name!r}: unknown requant roles "
                f"{sorted(unknown_rq)}; known: {list(ROLES)}"
            )

    def backend_for(self, role: str) -> Optional[str]:
        return self.rules.get(role, self.default)

    def requant_for(self, role: str) -> Optional[float]:
        """The calibrated re-quant scale of a ``role``'s hidden GEMM output,
        or None to write it in full precision."""
        return self.requant.get(role)

    def describe(self) -> Dict[str, str]:
        """role -> backend table (for reports)."""
        return {role: (self.backend_for(role) or "<default>") for role in ROLES}


def mlp_q8_policy(*, moe: bool = True, requant_scale: Optional[float] = None
                  ) -> PrecisionPolicy:
    """The serving-side split: MLP GEMMs (and, with ``moe=True``, the routed
    experts and the shared-expert MLP) run int8; attention, router and
    logits stay full precision. ``requant_scale`` (a calibrated per-tensor
    scale) makes the MLP role write its hidden activation through a
    ``requant_int8`` epilogue for the down projection."""
    rules: Dict[str, Optional[str]] = {"mlp": "q8"}
    if moe:
        rules["moe"] = "q8"
    requant: Dict[str, float] = (
        {"mlp": float(requant_scale)} if requant_scale is not None else {}
    )
    return PrecisionPolicy(rules=rules, requant=requant, name="mlp-q8")
