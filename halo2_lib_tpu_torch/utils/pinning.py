"""Circuit pinning: serialize the exact prover layout for reproducible proving.

Role of halo2-base's `KeygenCircuitIntent` / `Pinning` / `create_pk_and_pinning`
(utils/halo2.rs:82-140, SURVEY.md §5 checkpoint/resume): `BaseCircuitParams` +
`MultiPhaseThreadBreakPoints` fully determine the prover's physical layout;
they round-trip through JSON and reconstruct a witness-gen-only builder with
`BaseCircuitBuilder.prover(params, break_points)`.
"""

from __future__ import annotations

import json

from ..gates.circuit import BaseCircuitBuilder, BaseCircuitParams


class Pinning:
    def __init__(self, params: BaseCircuitParams, break_points: list[list[int]]):
        self.params = params
        self.break_points = break_points

    def to_json(self) -> str:
        return json.dumps(
            {"params": self.params.to_json(), "break_points": self.break_points}
        )

    @staticmethod
    def from_json(s: str) -> "Pinning":
        d = json.loads(s)
        return Pinning(BaseCircuitParams.from_json(d["params"]), d["break_points"])

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def read(path: str) -> "Pinning":
        with open(path) as f:
            return Pinning.from_json(f.read())

    def prover_builder(self, field=None) -> BaseCircuitBuilder:
        """Witness-gen-only builder pinned to this layout (builder.rs:94-99)."""
        kwargs = {} if field is None else {"field": field}
        return BaseCircuitBuilder.prover(self.params, self.break_points, **kwargs)


def pinning_of(builder: BaseCircuitBuilder) -> Pinning:
    """Extract pinning after synthesize/keygen computed break points."""
    return Pinning(builder.config_params, builder.break_points())
