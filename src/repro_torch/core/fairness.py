"""Multi-tenant fairness: per-user budget ledgers and the weighted-fair
placement term.

- :class:`FairShare` — the frozen budget policy: joules (and optionally
  gCO2) granted per replenish window per unit weight, plus the fairness
  pressure ``mu`` the objective term applies.
- :class:`FairnessLedger` — a deficit-counter ledger over a user
  population, settled lazily per user.  A user's **debt** is how many
  replenish windows of budget they are behind, capped at ``debt_cap``.
- :class:`FairnessWeights` — the frozen per-placement-call snapshot the
  schedulers consume; :meth:`FairnessWeights.from_ledger` returns ``None``
  when every submitting user is debt-free.

The objective term is an **advantage tax**: an indebted user's task is
charged ``mu * debt`` times the advantage a candidate endpoint offers over
the fleet-mean prediction (``relu(mean - predicted)``, energy under
``alpha``, runtime under ``1-alpha``, both SF-normalized like the base
objective), steering over-budget users off premium endpoints.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class FairShare:
    """Frozen per-user budget policy.

    ``budget_j`` joules are granted per ``window_s`` seconds per unit
    weight (``weights`` maps user -> share weight, default 1.0 — a user
    with weight 2 earns twice the budget).  ``budget_g`` optionally adds
    a carbon budget in gCO2 per window.  Unused credit banks up to
    ``bank_windows`` windows' worth; debt accrues unbounded but is
    *reported* capped at ``debt_cap`` windows so one pathological user
    cannot blow up the objective term.  ``mu`` scales the advantage-tax
    placement term (0 disables it while keeping admission accounting).
    """

    budget_j: float
    window_s: float = 60.0
    mu: float = 1.0
    weights: Mapping[str, float] | None = None
    budget_g: float | None = None
    debt_cap: float = 8.0
    bank_windows: float = 1.0

    def __post_init__(self) -> None:
        if self.budget_j <= 0.0:
            raise ValueError(f"budget_j must be positive, got {self.budget_j}")
        if self.window_s <= 0.0:
            raise ValueError(f"window_s must be positive, got {self.window_s}")
        if self.mu < 0.0:
            raise ValueError(f"mu must be non-negative, got {self.mu}")
        if self.budget_g is not None and self.budget_g <= 0.0:
            raise ValueError(f"budget_g must be positive, got {self.budget_g}")
        if self.debt_cap <= 0.0:
            raise ValueError(f"debt_cap must be positive, got {self.debt_cap}")
        if self.bank_windows < 0.0:
            raise ValueError(
                f"bank_windows must be non-negative, got {self.bank_windows}"
            )
        if self.weights is not None:
            bad = {u: w for u, w in self.weights.items() if w <= 0.0}
            if bad:
                raise ValueError(f"share weights must be positive: {bad}")

    def ledger(self) -> "FairnessLedger":
        return FairnessLedger(self)


class FairnessLedger:
    """Deficit-counter energy/carbon ledger over a user population.

    Accounting is in *epochs*: :meth:`advance` maps wall-clock seconds to
    ``floor(now / window_s)`` and only moves forward.  Each account is a
    ``[credit_j, credit_g, last_epoch]`` triple settled lazily on access:
    elapsed epochs credit one quantum each (``budget * weight``), capped
    at the bank, then charges subtract.  A never-seen user settles to a
    full bank — new tenants start paid-up.

    :meth:`debt` converts a negative balance into "windows behind"
    (``-credit / quantum``), summing the energy and carbon components and
    clamping to ``share.debt_cap``; it is the dimensionless weight the
    advantage-tax term and the admission threshold both consume.
    """

    def __init__(self, share: FairShare):
        self.share = share
        self._epoch = 0
        self._w = dict(share.weights) if share.weights else {}
        # user -> [credit_j, credit_g, last_settled_epoch]
        self._acct: dict[str, list] = {}

    # -- time ----------------------------------------------------------
    def advance(self, now: float) -> int:
        """Advance the replenish epoch to ``floor(now / window_s)``
        (monotone — a stale ``now`` never rolls credit back).  Returns
        the current epoch."""
        ep = int(math.floor(now / self.share.window_s))
        if ep > self._epoch:
            self._epoch = ep
        return self._epoch

    def next_replenish(self, now: float) -> float:
        """Wall-clock time of the next budget replenish after ``now`` —
        the release time admission control defers over-budget work to."""
        w = self.share.window_s
        return (math.floor(now / w) + 1.0) * w

    # -- accounts ------------------------------------------------------
    def _quanta(self, user: str) -> tuple[float, float]:
        w = self._w.get(user, 1.0)
        qg = (self.share.budget_g or 0.0) * w
        return self.share.budget_j * w, qg

    def _settle(self, user: str) -> list:
        qj, qg = self._quanta(user)
        bank = self.share.bank_windows
        acct = self._acct.get(user)
        if acct is None:
            acct = self._acct[user] = [bank * qj, bank * qg, self._epoch]
            return acct
        lag = self._epoch - acct[2]
        if lag > 0:
            acct[0] = min(acct[0] + lag * qj, bank * qj)
            if qg:
                acct[1] = min(acct[1] + lag * qg, bank * qg)
            acct[2] = self._epoch
        return acct

    def charge(self, user: str, energy_j: float, carbon_g: float = 0.0) -> None:
        """Debit ``energy_j`` joules (and optionally ``carbon_g`` grams)
        against ``user``'s account."""
        acct = self._settle(user)
        acct[0] -= energy_j
        if carbon_g:
            acct[1] -= carbon_g

    def credit_j(self, user: str) -> float:
        """Current energy balance in joules (negative = in debt)."""
        return self._settle(user)[0]

    def debt(self, user: str) -> float:
        """How many replenish windows of budget ``user`` is behind
        (0.0 when in credit), capped at ``share.debt_cap``."""
        acct = self._settle(user)
        qj, qg = self._quanta(user)
        d = -acct[0] / qj if acct[0] < 0.0 else 0.0
        if qg and acct[1] < 0.0:
            d += -acct[1] / qg
        cap = self.share.debt_cap
        return d if d < cap else cap

    @property
    def tracks_carbon(self) -> bool:
        return self.share.budget_g is not None

    def users(self) -> list[str]:
        """Users with an opened account (charged or queried at least
        once) — NOT the simulated universe, which is never materialized."""
        return sorted(self._acct)


@dataclasses.dataclass(frozen=True)
class FairnessWeights:
    """Frozen per-placement-call fairness snapshot (the
    ``CarbonWeights``/``WarmWeights`` pattern): ``debt`` maps user ->
    positive windows-behind weight, ``mu`` scales the advantage-tax
    objective term.  Only indebted users appear — schedulers read
    ``debt.get(task.user, 0.0)`` and a miss keeps that task's candidate
    scores bitwise-unchanged.  On the SoA engine the per-task debt joins
    the run-memoization key, so runs never mix tasks taxed differently.
    """

    debt: Mapping[str, float]
    mu: float = 1.0

    def __post_init__(self) -> None:
        if self.mu < 0.0:
            raise ValueError(f"mu must be non-negative, got {self.mu}")
        bad = {u: d for u, d in self.debt.items() if d <= 0.0}
        if bad:
            raise ValueError(f"fairness debts must be positive: {bad}")

    @classmethod
    def from_ledger(
        cls, ledger: FairnessLedger, tasks: Sequence, mu: float | None = None
    ) -> "FairnessWeights | None":
        """Snapshot the debts of every user submitting in ``tasks``.
        Returns None when all of them are debt-free (or ``mu`` resolves
        to 0), keeping the engines on the unmodified hot path."""
        eff_mu = ledger.share.mu if mu is None else mu
        if eff_mu == 0.0:
            return None
        debt: dict[str, float] = {}
        seen: set[str] = set()
        for t in tasks:
            u = t.user
            if u in seen:
                continue
            seen.add(u)
            d = ledger.debt(u)
            if d > 0.0:
                debt[u] = d
        if not debt:
            return None
        return cls(debt, eff_mu)
