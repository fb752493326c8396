"""Fleet fault tolerance: heartbeat failure detection, deterministic data-
shard reassignment, and straggler-aware rebalancing.

No real multi-host runtime exists in this container, so this module is the
*control-plane logic* a 1000+-node deployment plugs into its coordinator:
pure, deterministic, unit-tested.  The data pipeline (data/tokens.py) is
stateless in (step, row), so reassignment is just handing out different row
ranges — no data-state migration.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class HeartbeatMonitor:
    """Tracks host heartbeats; flags failures (silence > timeout) and
    stragglers (step latency above ``straggler_factor`` x fleet median)."""

    n_hosts: int
    timeout: float = 60.0
    straggler_factor: float = 2.0
    last_seen: dict[int, float] = field(default_factory=dict)
    step_latency: dict[int, float] = field(default_factory=dict)

    def heartbeat(self, host: int, now: float,
                  step_latency: float | None = None) -> None:
        self.last_seen[host] = now
        if step_latency is not None:
            self.step_latency[host] = step_latency

    def failed(self, now: float) -> list[int]:
        return sorted(h for h in range(self.n_hosts)
                      if now - self.last_seen.get(h, -1e18) > self.timeout)

    def stragglers(self, now: float) -> list[int]:
        alive = [h for h in range(self.n_hosts)
                 if h not in set(self.failed(now))]
        lats = sorted(self.step_latency.get(h, 0.0) for h in alive)
        if not lats:
            return []
        median = lats[len(lats) // 2]
        if median <= 0:
            return []
        return sorted(h for h in alive
                      if self.step_latency.get(h, 0.0)
                      > self.straggler_factor * median)


def reassign_shards(global_batch: int, alive_hosts: list[int],
                    weights: dict[int, float] | None = None
                    ) -> dict[int, range]:
    """Deterministically split ``global_batch`` rows over the alive hosts.

    ``weights`` < 1.0 shrink a straggler's share (its rows spill to faster
    hosts).  Every host computes the same assignment from the same inputs —
    no coordinator round-trip needed beyond the alive-set + weights."""
    alive = sorted(alive_hosts)
    if not alive:
        raise ValueError("no alive hosts")
    w = {h: (weights or {}).get(h, 1.0) for h in alive}
    total = sum(w.values())
    # largest-remainder apportionment, deterministic tie-break by host id
    exact = {h: global_batch * w[h] / total for h in alive}
    base = {h: int(exact[h]) for h in alive}
    rem = global_batch - sum(base.values())
    order = sorted(alive, key=lambda h: (-(exact[h] - base[h]), h))
    for h in order[:rem]:
        base[h] += 1
    out, lo = {}, 0
    for h in alive:
        out[h] = range(lo, lo + base[h])
        lo += base[h]
    assert lo == global_batch
    return out


@dataclass
class ElasticPlan:
    """Decision record produced by the coordinator each control interval."""
    alive: list[int]
    assignments: dict[int, range]
    restarted_from_step: int | None = None


def control_tick(monitor: HeartbeatMonitor, now: float, global_batch: int,
                 checkpoint_step: int | None) -> ElasticPlan:
    """One coordinator control-loop tick: drop failed hosts, shrink
    stragglers' shards, decide whether a restart-from-checkpoint is needed
    (a failure mid-step requires rolling back to the last checkpoint)."""
    failed = set(monitor.failed(now))
    alive = [h for h in range(monitor.n_hosts) if h not in failed]
    stragglers = set(monitor.stragglers(now))
    weights = {h: (0.5 if h in stragglers else 1.0) for h in alive}
    return ElasticPlan(
        alive=alive,
        assignments=reassign_shards(global_batch, alive, weights),
        restarted_from_step=checkpoint_step if failed else None)
