"""EC policy names (port of hdrf_tpu/ops/rs.py:42-51, ``parse_policy``).

Apart from ops/rs.py, which loads torch and the RS kernel's wrapper, so
that the NameNode, which only parses and validates policy names, never
loads torch: its monitor parses them under the namesystem lock
(``_check_ec_groups``), where a first import of torch once held every
heartbeat and lifeline past the dead-node verdict.  ops/rs.py re-exports
``parse_policy``.
"""

from __future__ import annotations


def parse_policy(policy: str) -> tuple[int, int, int]:
    """'rs-6-3-64k' -> (k, m, cell_bytes) (ECPolicyLoader analog)."""
    parts = policy.lower().split("-")
    if len(parts) != 4 or parts[0] != "rs":
        raise ValueError(f"bad EC policy {policy!r} (want rs-<k>-<m>-<cell>k)")
    k, m = int(parts[1]), int(parts[2])
    cell = int(parts[3].rstrip("k")) * 1024
    if not (1 <= k <= 24 and 1 <= m <= 8 and cell > 0):
        raise ValueError(f"bad EC policy {policy!r}")
    return k, m, cell
