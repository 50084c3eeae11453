"""State carried across from the JAX package.

The system has no weights: its state is the SRS and the proving key. Both
packages read the same ``params/kzg_bn254_{k}.srs``. The device layouts
agree (limb-major 16-bit limbs, Montgomery form with R = 2^256), so limb
tensors cross as they are, and a proving key crosses as its host columns,
its verifying key's bytes and its sigma tensor. A test can then hand the JAX
package's key to the port's prover, which tells a prover fault from a keygen
fault.
"""

from __future__ import annotations

import numpy as np
import torch

from .backend.keygen import ProvingKey, VerifyingKey


def limbs_from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """uint32 (or uint16) limbs -> the port's int32 tensor on `device`;
    every limb is < 2^16, so the values are unchanged."""
    a = np.asarray(arr)
    if a.size and int(a.max()) > 0xFFFF:
        raise ValueError("limb values must be 16-bit")
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(device)


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """The port's int32 limbs -> uint32 numpy (the JAX package's dtype)."""
    return t.detach().cpu().numpy().astype(np.uint32)


def _ints(limbs16: np.ndarray) -> list[list[int]]:
    """uint16[C, n, 16] little-endian limbs -> C int columns."""
    out = []
    for col in np.asarray(limbs16, dtype="<u2"):
        buf = col.tobytes()
        out.append([int.from_bytes(buf[32 * i : 32 * (i + 1)], "little") for i in range(col.shape[0])])
    return out


def proving_key_from_numpy(d, device) -> ProvingKey:
    """The port's ProvingKey (with its VerifyingKey) from the JAX key's host
    fields, as ``tests/data/torch_goldens/make_goldens.py`` writes them:

    ``vk`` (uint8 vk bytes), ``selectors`` (uint8[na, n]), ``fixed_cols`` and
    ``dynen_cols`` (uint16[C, n, 16]), optional ``table_col`` and
    ``q_lookup_col`` (uint16[n, 16]), ``perm_values`` (uint16/uint32
    [ncols, 16, n])."""
    vk = VerifyingKey.from_bytes(bytes(np.asarray(d["vk"], dtype=np.uint8)))
    n = 1 << vk.k
    sel = np.asarray(d["selectors"]).reshape(-1, n)
    selectors = [[int(v) for v in row] for row in sel]
    keys = set(d.keys()) if hasattr(d, "keys") else set(d.files)
    table_col = _ints(np.asarray(d["table_col"])[None])[0] if "table_col" in keys else None
    q_lookup_col = _ints(np.asarray(d["q_lookup_col"])[None])[0] if "q_lookup_col" in keys else None
    return ProvingKey(
        vk=vk,
        selectors=selectors,
        fixed_cols=_ints(d["fixed_cols"]),
        table_col=table_col,
        q_lookup_col=q_lookup_col,
        perm_values=limbs_from_numpy(d["perm_values"], device),
        break_points=[],
        config_params=None,
        dynen_cols=_ints(d["dynen_cols"]),
    )
