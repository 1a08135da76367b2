"""Data-transfer time + energy models (paper §III-E).

Energy per transfer n1 -> n2:
    E = sum_h  s * E_inc,   E_inc = P_max / B  per hop
Transfer time: online linear regression on (n_files, total_bytes), batched
per destination to amortize per-transfer overheads (Globus limits analogue).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.endpoint import EndpointSpec

# Typical network-device specs (core/edge routers + switches on the path).
# E_inc = P_max / B, in J/byte (8 bits/byte folded in).
HOP_PMAX_W = 4000.0
HOP_BW_BPS = 100e9  # 100 Gb/s
E_INC_J_PER_BYTE = HOP_PMAX_W / HOP_BW_BPS * 8.0  # 3.2e-7 J/B per hop
FS_DTN_EXTRA_HOPS = 2  # shared-FS data servers + DTN, when applicable


@dataclasses.dataclass(frozen=True)
class TransferRequest:
    src: str
    dst: str
    n_files: int
    total_bytes: float
    shared: bool = False  # cacheable across tasks on an endpoint


class TransferModel:
    def __init__(self, endpoints: list[EndpointSpec]):
        self.eps = {e.name: e for e in endpoints}
        # time regression t = a + b*n_files + c*bytes
        self._xtx = np.eye(3) * 1e-6
        self._xty = np.zeros(3)
        # sane prior: 2 s setup, 5 ms/file, 10 GB/s effective
        self.observe(n_files=1, total_bytes=1e9, seconds=2.105)
        self.observe(n_files=100, total_bytes=1e10, seconds=3.5)
        self._cache: set[tuple[str, str]] = set()  # (endpoint, file-group key)

    # --- time -------------------------------------------------------------
    def observe(self, n_files: int, total_bytes: float, seconds: float) -> None:
        x = np.array([1.0, n_files, total_bytes / 1e9])
        self._xtx += np.outer(x, x)
        self._xty += x * seconds
        self._coef = None  # refit lazily on next prediction

    def predict_seconds(self, n_files: int, total_bytes: float) -> float:
        if n_files == 0 or total_bytes <= 0:
            return 0.0
        if self._coef is None:
            self._coef = [float(c) for c in np.linalg.solve(self._xtx, self._xty)]
        c0, c1, c2 = self._coef
        t = c0 + c1 * n_files + c2 * (total_bytes / 1e9)
        return t if t > 0.0 else 0.0

    # --- energy -----------------------------------------------------------
    def hops(self, src: str, dst: str) -> int:
        if src == dst:
            return 0
        h = self.eps[src].hop_count(dst)
        extra = 0
        if self.eps[src].has_batch_scheduler:
            extra += FS_DTN_EXTRA_HOPS
        if self.eps[dst].has_batch_scheduler:
            extra += FS_DTN_EXTRA_HOPS
        return h + extra

    def energy_j(self, req: TransferRequest) -> float:
        if req.src == req.dst:
            return 0.0
        if req.shared and (req.dst, f"{req.src}:{req.n_files}:{req.total_bytes}") in self._cache:
            return 0.0
        return self.hops(req.src, req.dst) * req.total_bytes * E_INC_J_PER_BYTE

    def mark_cached(self, req: TransferRequest) -> None:
        if req.shared:
            self._cache.add((req.dst, f"{req.src}:{req.n_files}:{req.total_bytes}"))

    # --- batching (paper: transfers batched before execution) -------------
    def batch_cost(
        self, reqs: list[TransferRequest]
    ) -> tuple[float, float]:
        """(seconds, joules) for a batched set of transfers, grouped by
        (src, dst) pair; batches to a destination run concurrently."""
        by_pair: dict[tuple[str, str], list[TransferRequest]] = {}
        for r in reqs:
            if r.src != r.dst:
                by_pair.setdefault((r.src, r.dst), []).append(r)
        total_j, max_s = 0.0, 0.0
        for (src, dst), rs in by_pair.items():
            nf = sum(r.n_files for r in rs)
            nb = sum(r.total_bytes for r in rs)
            max_s = max(max_s, self.predict_seconds(nf, nb))
            total_j += sum(self.energy_j(r) for r in rs)
        return max_s, total_j
