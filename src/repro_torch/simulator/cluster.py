"""Cluster-scale scheduling: one shared-BatchState scheduler, many nodes.

Reproduces the paper's Sec. 4.4 scalability study (Fig. 12): a single
central SageSched scheduler in front of up to 64 nodes, load scaled
proportionally (8 RPS per node), queue depth up to 1000.  Three layers:

  * **ClusterScheduler** — the central scheduler: ONE ``repro_torch.core.
    Scheduler`` whose BatchState holds every live request across all
    nodes (a ``node_id`` column joins the SoA vectors).  ``refresh()``
    recomputes all dirty priorities cluster-wide in one batched backend
    pass; per-node ranking is ``order(node_id=n)`` — a masked lexsort
    over the shared arrays.  Each node drives the scheduler through a
    ``NodeSchedulerView``, which binds the node's identity into the
    surface ``NodeSimulator`` expects.

  * **Routers** — pluggable placement policies.  ``JoinShortestWork
    Router`` is the Llumnix-style baseline: a decayed outstanding-token
    counter fed by the fixed admission-time guess ``input_len + 2*256``.
    ``CostAwareRouter`` replaces the guess with the request's predicted
    ``CostDistribution`` mean (the same predictor + cost model the
    scheduler uses) and respects each node's KV-memory headroom through
    a per-node ``repro_torch.serving.kv_cache.KVCacheManager``.

  * **Event-driven loop** — ``simulate_cluster`` interleaves arrival /
    step-complete / finish events across nodes: requests are routed at
    their global arrival times against *live* cluster state, and a node
    never fast-forwards a decode run past an unrouted arrival (the
    ``horizon`` handed to ``NodeSimulator.step``).  ``shared_state=
    False`` runs the identical loop with one private Scheduler per node
    — the fanout baseline the parity tests compare against
    (tests/test_cluster.py asserts metric *equality* under identical
    JSOW routing).

``measure_scheduler_overhead`` times the paper's Fig. 12 quantities —
per-request predict and schedule wall-clock at cluster load — against
this real batched path (admit into shared state, cluster-wide refresh,
node-masked order), not a hand-rolled sorted-list stand-in.  See
docs/cluster_scheduling.md.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..core.cost_model import CostModel, ResourceBoundCost
from ..core.predictor import Predictor, SemanticHistoryPredictor
from ..core.scheduler import Scheduler
from ..serving.kv_cache import KVCacheManager
from .service_model import NodeSpec
from .simulator import NodeSimulator, SimResult
from .workload import SimRequest

__all__ = [
    "ClusterResult", "ClusterScheduler", "NodeSchedulerView",
    "Router", "JoinShortestWorkRouter", "CostAwareRouter", "make_router",
    "ROUTER_NAMES", "NodeKill", "NodeSlow", "simulate_cluster",
    "measure_scheduler_overhead",
]


# ----------------------------------------------------------- fault events

@dataclass(frozen=True)
class NodeKill:
    """Kill node ``node_id`` at simulated time ``at``: its in-flight
    requests are re-routed to surviving nodes (host-resident swap
    payloads move with them; device-resident KV is re-prefilled) or
    aborted when no node remains."""

    node_id: int
    at: float


@dataclass(frozen=True)
class NodeSlow:
    """Slow node ``node_id`` down by ``factor`` from time ``at`` on —
    thermal throttling / degraded interconnect.  Compounding: two
    NodeSlow events multiply."""

    node_id: int
    at: float
    factor: float = 4.0


# ---------------------------------------------------------------- routers

class Router:
    """Placement policy: assigns each arriving request to a node.

    ``route`` is called once per request, at its global arrival time, in
    arrival order (ties processed in input order — see the event loop).
    ``on_complete`` lets stateful routers release per-request
    accounting when the serving node finishes the request.
    """

    name = "base"
    dead: frozenset = frozenset()   # nodes removed from placement

    def mark_dead(self, node_id: int) -> None:
        """Remove a node from future placement decisions (node-kill
        fault).  Instance-level copy-on-write so the class default
        stays shared and empty."""
        self.dead = set(self.dead) | {int(node_id)}

    def route(self, req: SimRequest) -> int:
        raise NotImplementedError

    def route_batch(self, reqs: list[SimRequest]) -> list[int]:
        """Route a burst of same-tick arrivals.  Placement is inherently
        sequential (each decision shifts the load the next one sees), so
        the default loops ``route`` in input order; routers with an
        expensive per-request stage (the cost router's prediction)
        override this to batch that stage and keep only the cheap
        placement loop sequential."""
        return [self.route(r) for r in reqs]

    def on_complete(self, request_id: str, node_id: int) -> None:
        pass


class JoinShortestWorkRouter(Router):
    """Join-shortest-outstanding-work on an admission-time token guess.

    The Llumnix-style baseline the paper's evaluation assumes: each
    request adds ``input_len + 2 * output_guess`` outstanding tokens to
    its node; outstanding work decays between arrivals at a nominal
    drain rate so early requests don't permanently bias routing.  Blind
    to demand uncertainty — the fixed guess is exactly what
    ``CostAwareRouter`` replaces.
    """

    name = "jsow"

    def __init__(self, n_nodes: int, drain_rate: float = 2000.0,
                 output_guess: float = 256.0):
        self.n_nodes = n_nodes
        self.drain_rate = drain_rate    # cost-units/s, nominal
        self.output_guess = output_guess
        self.outstanding = np.zeros(n_nodes)
        self._last_t = 0.0

    def route(self, req: SimRequest) -> int:
        # no expensive per-request stage to amortize here, so the base
        # class's sequential route_batch IS this router's burst form
        self.outstanding = np.maximum(
            0.0, self.outstanding
            - (req.arrival - self._last_t) * self.drain_rate)
        self._last_t = req.arrival
        if self.dead:
            masked = self.outstanding.copy()
            masked[list(self.dead)] = np.inf
            n = int(np.argmin(masked))
        else:
            n = int(np.argmin(self.outstanding))
        self.outstanding[n] += req.input_len + 2.0 * self.output_guess
        return n


class CostAwareRouter(Router):
    """Route on predicted service cost + live KV-memory headroom.

    Two uncertainty-aware upgrades over ``JoinShortestWorkRouter``
    (cf. LLMSched's uncertainty-aware DAG placement, arXiv:2504.03444,
    and the robust-routing argument of arXiv:2508.14544 — routing
    quality hinges on cost estimates that track prediction uncertainty):

      * outstanding work per node is the sum of *predicted cost means*
        (``CostModel.distribution`` pushforward of the length
        prediction) of the requests still assigned there — released on
        completion, so the counter tracks live queue state instead of a
        decayed admission-time guess;
      * each node's KV budget is mirrored in a ``KVCacheManager``
        (repro_torch.serving.kv_cache) charged with ``input_len + E[output]``
        tokens per request; nodes whose headroom cannot take the
        arriving request are avoided unless every node is saturated
        (then: least outstanding predicted work, ties to the largest
        headroom — outstanding keeps tracking queued requests even when
        the slot mirror is exhausted, so overload spreads instead of
        funneling to whichever node's mirror froze first).

    The router predicts once per request — for a burst, once per request
    in ONE ``predict_batch`` call (``route_batch``) — and the prediction
    is handed to ``Scheduler.admit`` through the node view
    (``take_prediction``), so the expensive semantic-history lookup is
    not paid twice.

    ``route_quantile=q`` routes on the q-quantile of the predicted cost
    distribution instead of its mean (robust placement under prediction
    uncertainty, arXiv:2508.14544): the support/probs are already
    computed at route time, so the knob costs one searchsorted.
    """

    name = "cost"

    def __init__(self, n_nodes: int, predictor: Predictor,
                 cost_model: CostModel | None = None,
                 spec: NodeSpec | None = None,
                 route_quantile: float | None = None):
        self.n_nodes = n_nodes
        self.predictor = predictor
        self.cost_model = cost_model or ResourceBoundCost()
        self.route_quantile = route_quantile
        if route_quantile is not None:
            if not 0.0 < route_quantile <= 1.0:
                raise ValueError(f"route_quantile must be in (0, 1], "
                                 f"got {route_quantile}")
            self.name = f"cost@q{route_quantile:g}"
        spec = spec or NodeSpec()
        cap = spec.kv_capacity_tokens
        self.kv = [KVCacheManager(n_slots=spec.max_batch, max_seq_len=cap,
                                  capacity_tokens=cap)
                   for _ in range(n_nodes)]
        self.outstanding = np.zeros(n_nodes)   # predicted cost units
        self._cost_of: dict[str, float] = {}
        self._dist_of: dict[str, object] = {}  # rid -> LengthDistribution

    def headroom(self, node_id: int) -> int:
        kv = self.kv[node_id]
        return kv.capacity_tokens - kv.used_tokens

    def take_prediction(self, request_id: str):
        """Hand the route-time length prediction to the admitting node
        (None for requests this router never saw)."""
        return self._dist_of.pop(request_id, None)

    def route(self, req: SimRequest) -> int:
        return self.route_batch([req])[0]

    def route_batch(self, reqs: list[SimRequest]) -> list[int]:
        """Batch the expensive stage — ONE ``predict_batch`` + cost
        pushforward sweep over the burst — then place sequentially (each
        placement charges the outstanding/KV state the next one sees)."""
        if not reqs:
            return []
        dists = self.predictor.predict_many(
            [r.prompt for r in reqs], [r.input_len for r in reqs])
        cost_dists = self.cost_model.distribution_batch(
            [r.input_len for r in reqs], dists)
        return [self._place(r, dist, cd)
                for r, dist, cd in zip(reqs, dists, cost_dists)]

    def _place(self, req: SimRequest, dist, cost_dist) -> int:
        cost = cost_dist.mean if self.route_quantile is None \
            else cost_dist.quantile(self.route_quantile)
        need_kv = int(req.input_len + dist.mean)
        fits = np.array([self.kv[n].can_admit(need_kv)
                         for n in range(self.n_nodes)])
        out = self.outstanding
        if self.dead:
            fits[list(self.dead)] = False
            out = out.copy()
            out[list(self.dead)] = np.inf
        if fits.any():
            # among nodes with headroom: least outstanding predicted work
            masked = np.where(fits, out, np.inf)
            n = int(np.argmin(masked))
        else:
            # cluster saturated: least outstanding predicted work (the
            # KV mirror freezes once its slot pool is exhausted, so
            # headroom alone would funnel all overload to one node);
            # ties go to the node with the most KV headroom; dead nodes
            # carry inf outstanding so they only win if every node died
            heads = np.array([self.headroom(i)
                              for i in range(self.n_nodes)], np.float64)
            n = int(np.lexsort((-heads, out))[0])
        kv = self.kv[n]
        if kv.free_slots > 0 and kv.blocks_for(need_kv) <= kv.free_blocks:
            # mirror the token charge; under deep backlog (> max_batch
            # queued requests) the slot pool — or, post block-table
            # refactor, the physical block pool — is exhausted: the node
            # is saturated anyway, so skip the mirror rather than crash
            # (on_complete's holds() check keeps release() symmetric)
            kv.allocate(req.request_id, need_kv)
        self.outstanding[n] += cost
        self._cost_of[req.request_id] = cost
        self._dist_of[req.request_id] = dist
        return n

    def on_complete(self, request_id: str, node_id: int) -> None:
        if self.kv[node_id].holds(request_id):
            self.kv[node_id].release(request_id)
        self.outstanding[node_id] -= self._cost_of.pop(request_id, 0.0)
        self._dist_of.pop(request_id, None)


ROUTER_NAMES = ("jsow", "cost")


def make_router(name, n_nodes: int, *, predictor: Predictor | None = None,
                cost_model: CostModel | None = None,
                spec: NodeSpec | None = None,
                route_quantile: float | None = None) -> Router:
    """Resolve a router spec; instances pass through.  ``route_quantile``
    selects quantile-of-cost routing for the cost router (robust to
    heavy-tailed predictions; only meaningful with ``name="cost"``)."""
    if isinstance(name, Router):
        if route_quantile is not None:
            raise ValueError("route_quantile cannot be applied to an "
                             "already-constructed Router instance; pass "
                             "CostAwareRouter(..., route_quantile=...) "
                             "directly")
        return name
    if name == "jsow":
        if route_quantile is not None:
            raise ValueError("route_quantile only applies to the cost "
                             "router")
        return JoinShortestWorkRouter(n_nodes)
    if name == "cost":
        if predictor is None:
            raise ValueError("cost router needs the central predictor")
        return CostAwareRouter(n_nodes, predictor, cost_model, spec,
                               route_quantile=route_quantile)
    raise KeyError(f"unknown router {name!r}; have {ROUTER_NAMES}")


# ------------------------------------------------------- central scheduler

class NodeSchedulerView:
    """One node's facade over a (possibly shared) Scheduler.

    Exposes exactly the surface ``NodeSimulator`` drives.  With
    ``masked=True`` the underlying scheduler is cluster-shared:
    ``admit`` stamps the node id and parameterless ``order`` calls
    become node-masked lexsorts, so the node only ever ranks its own
    queue while refreshes stay cluster-wide.  With ``masked=False`` the
    scheduler is private to the node (the fanout baseline) and calls
    pass straight through.  Either way ``on_complete`` notifies the
    router so placement accounting tracks live state.
    """

    def __init__(self, scheduler: Scheduler, node_id: int, *,
                 masked: bool, router: Router | None = None):
        self.scheduler = scheduler
        self.node_id = node_id
        self.masked = masked
        self.router = router

    # lifecycle -----------------------------------------------------------

    def admit(self, request_id: str, prompt: str, input_len: int,
              arrival: float | None = None):
        # reuse the router's route-time prediction when it made one
        # (cost router) instead of re-running the semantic lookup
        ld = self.router.take_prediction(request_id) \
            if hasattr(self.router, "take_prediction") else None
        return self.scheduler.admit(
            request_id, prompt, input_len, arrival=arrival,
            node_id=self.node_id if self.masked else -1, length_dist=ld)

    def admit_batch(self, request_ids, prompts, input_lens, *,
                    arrivals=None):
        """Batched admission for a burst landing on this node: node-id
        stamping + per-request reuse of route-time predictions, then one
        ``Scheduler.admit_batch`` pass over the shared state."""
        lds = None
        if hasattr(self.router, "take_prediction"):
            lds = [self.router.take_prediction(r) for r in request_ids]
        return self.scheduler.admit_batch(
            request_ids, prompts, input_lens, arrivals=arrivals,
            node_ids=self.node_id if self.masked else -1,
            length_dists=lds)

    def on_complete(self, request_id: str, output_len: int) -> None:
        self.scheduler.on_complete(request_id, output_len)
        if self.router is not None:
            self.router.on_complete(request_id, self.node_id)

    def on_abort(self, request_id: str) -> None:
        self.scheduler.on_abort(request_id)
        if self.router is not None:
            self.router.on_complete(request_id, self.node_id)

    # passthrough ---------------------------------------------------------

    def order(self, request_ids=None, **kwargs):
        if request_ids is None and self.masked:
            return self.scheduler.order(node_id=self.node_id, **kwargs)
        return self.scheduler.order(request_ids, **kwargs)

    def on_progress(self, request_id: str, generated: int) -> None:
        self.scheduler.on_progress(request_id, generated)

    def on_progress_many(self, request_ids, generated) -> None:
        self.scheduler.on_progress_many(request_ids, generated)

    def min_tokens_to_refresh(self, request_ids) -> float:
        return self.scheduler.min_tokens_to_refresh(request_ids)

    def tokens_to_refresh(self, request_id: str) -> float:
        return self.scheduler.tokens_to_refresh(request_id)

    def eviction_order(self, request_ids, **kwargs) -> list[str]:
        # capacity-forced eviction ranks explicit ids, so it needs no
        # node mask (NodeSimulator calls it once the node's KV is full)
        return self.scheduler.eviction_order(request_ids, **kwargs)

    def set_now(self, now: float) -> None:
        self.scheduler.set_now(now)

    def get(self, request_id: str):
        return self.scheduler.get(request_id)

    def __contains__(self, request_id: str) -> bool:
        return request_id in self.scheduler

    @property
    def policy(self):
        return self.scheduler.policy

    @property
    def runtime_refreshing(self) -> bool:
        return self.scheduler.runtime_refreshing

    @property
    def preemptive(self) -> bool:
        return self.scheduler.preemptive

    @property
    def stats(self) -> dict:
        return self.scheduler.stats


class ClusterScheduler:
    """The paper's central-scheduler topology as a first-class object.

    One shared ``Scheduler`` (one BatchState spanning every node's live
    requests) + a placement ``Router``.  ``view(n)`` hands node *n* its
    ``NodeSchedulerView``; ``route(req)`` makes the placement decision;
    ``refresh()`` is the cluster-wide batched priority recomputation;
    ``order(node_id=n)`` ranks one node's queue by masked lexsort.
    """

    def __init__(self, scheduler: Scheduler | None = None,
                 n_nodes: int = 1, router="jsow",
                 spec: NodeSpec | None = None,
                 route_quantile: float | None = None):
        # explicit None-check: Scheduler defines __len__, so an *empty*
        # scheduler is falsy and `scheduler or Scheduler()` would silently
        # swap a caller's configured scheduler for a default one
        self.scheduler = Scheduler() if scheduler is None else scheduler
        self.n_nodes = n_nodes
        self.router = make_router(router, n_nodes,
                                  predictor=self.scheduler.predictor,
                                  cost_model=self.scheduler.cost_model,
                                  spec=spec, route_quantile=route_quantile)

    def view(self, node_id: int) -> NodeSchedulerView:
        return NodeSchedulerView(self.scheduler, node_id, masked=True,
                                 router=self.router)

    def route(self, req: SimRequest) -> int:
        return self.router.route(req)

    def route_batch(self, reqs: list[SimRequest]) -> list[int]:
        """Place a burst of same-tick arrivals: the router's expensive
        stage (prediction) runs once, batched, for the whole burst."""
        return self.router.route_batch(reqs)

    def refresh(self) -> int:
        return self.scheduler.refresh()

    def order(self, node_id: int | None = None, **kwargs) -> list[str]:
        return self.scheduler.order(node_id=node_id, **kwargs)

    def outstanding_by_node(self) -> np.ndarray:
        return self.scheduler.outstanding_by_node(self.n_nodes)

    def __len__(self) -> int:
        return len(self.scheduler)


# ------------------------------------------------------------- event loop

@dataclass
class ClusterResult:
    node_results: list[SimResult]
    mean_ttlt: float
    mean_ttft: float
    router: str = "jsow"
    requests_per_node: list[int] = field(default_factory=list)
    aborted: list[str] = field(default_factory=list)  # no node left to adopt
    migrated: int = 0           # in-flight requests re-routed off dead nodes

    @property
    def n_nodes(self) -> int:
        return len(self.node_results)

    @property
    def metrics(self):
        return [m for res in self.node_results for m in res.metrics]


def simulate_cluster(requests: list[SimRequest], scheduler_factory,
                     n_nodes: int, spec: NodeSpec | None = None, *,
                     router="jsow", shared_state: bool = True,
                     route_quantile: float | None = None,
                     faults=None,
                     node_kwargs: dict | None = None) -> ClusterResult:
    """Event-driven multi-node simulation under a central scheduler.

    Arrival, step-complete, and finish events interleave across nodes:
    the loop always advances whichever entity is earliest in simulated
    time — routing the next request once every busy node has caught up
    to its arrival, otherwise stepping the furthest-behind node one
    scheduling round (capped at the next global arrival, so routing
    decisions always see live queue state).  *Same-tick* arrivals (equal
    timestamps) are coalesced into one burst: routed together through
    ``Router.route_batch`` (one batched prediction for the cost router)
    and admitted per node through ``admit_batch`` — still in input
    order, so placement is deterministic.  Node ties break by node
    index (regression-tested).

    shared_state=True (default): ``scheduler_factory()`` builds ONE
    scheduler whose BatchState holds the whole cluster's requests
    (central SageSched, paper Sec. 4.4).  shared_state=False: one
    private scheduler per node — the fanout baseline; under identical
    routing both modes produce identical request metrics
    (tests/test_cluster.py parity tests).

    route_quantile: see ``CostAwareRouter`` (cost router only).

    faults: optional list of ``NodeKill`` / ``NodeSlow`` events,
    interleaved with arrivals in simulated-time order.  A kill drains
    the node (``NodeSimulator.kill``): swapped-out requests keep their
    host-resident payload and pay swap-in on the adoptive node;
    device-resident ones re-prefill, keeping already-streamed tokens.
    Orphans are re-routed through the (dead-node-masked) router, or
    recorded in ``ClusterResult.aborted`` when no node survives.

    node_kwargs: extra keyword arguments for every ``NodeSimulator``
    (e.g. ``prefill_chunk``, ``block_size``, ``prefix_sharing`` — the
    session-workload sharing experiments run through here).
    """
    reqs = sorted(requests, key=lambda r: r.arrival)
    if shared_state:
        cs = ClusterScheduler(scheduler_factory(), n_nodes, router=router,
                              spec=spec, route_quantile=route_quantile)
        router_obj = cs.router
        views = [cs.view(n) for n in range(n_nodes)]
    else:
        scheds = [scheduler_factory() for _ in range(n_nodes)]
        router_obj = make_router(router, n_nodes,
                                 predictor=scheds[0].predictor,
                                 cost_model=scheds[0].cost_model, spec=spec,
                                 route_quantile=route_quantile)
        views = [NodeSchedulerView(scheds[n], n, masked=False,
                                   router=router_obj)
                 for n in range(n_nodes)]
    sims = [NodeSimulator(views[n], spec, node_id=n,
                          **(node_kwargs or {}))
            for n in range(n_nodes)]
    per_node = [0] * n_nodes
    fault_q = sorted(faults or [], key=lambda f: (f.at, f.node_id))
    fi, aborted, migrated = 0, [], 0

    i, n_req = 0, len(reqs)
    while True:
        busy = [s for s in sims if s.busy]
        t_next = reqs[i].arrival if i < n_req else float("inf")
        t_fault = fault_q[fi].at if fi < len(fault_q) else float("inf")
        now_min = min((s.now for s in busy), default=float("inf"))
        if fi < len(fault_q) and t_fault <= min(t_next, now_min) + 1e-12:
            # fault fires before the next arrival and before any busy
            # node's frontier — kills beat same-tick arrivals so the
            # burst routes around the dead node
            f = fault_q[fi]
            fi += 1
            if isinstance(f, NodeSlow):
                sims[f.node_id].slow_down(f.factor)
            else:
                orphans = sims[f.node_id].kill(f.at)
                router_obj.mark_dead(f.node_id)
                if not any(s.alive for s in sims):
                    aborted.extend(lv.req.request_id for lv in orphans)
                elif orphans:
                    homes = router_obj.route_batch(
                        [lv.req for lv in orphans])
                    for lv, nid in zip(orphans, homes):
                        sims[nid].adopt(lv, f.at)
                        per_node[nid] += 1
                        migrated += 1
            continue
        if i < n_req and (not busy or t_next <= now_min + 1e-12):
            if not any(s.alive for s in sims):
                # whole cluster is down: remaining arrivals can never be
                # served — record them instead of routing into a wall
                aborted.extend(r.request_id for r in reqs[i:])
                i = n_req
                continue
            j = i + 1  # coalesce the same-tick burst (identical stamps)
            while j < n_req and reqs[j].arrival <= t_next + 1e-12:
                j += 1
            burst = reqs[i:j]
            i = j
            for r, nid in zip(burst, router_obj.route_batch(burst)):
                sims[nid].push(r)
                per_node[nid] += 1
            continue
        if not busy:
            break
        s = min(busy, key=lambda s: (s.now, s.node_id))
        s.step(horizon=min(t_next, t_fault))

    results = [s.finish() for s in sims]
    all_m = [m for res in results for m in res.metrics]
    return ClusterResult(
        node_results=results,
        mean_ttlt=float(np.mean([m.ttlt for m in all_m])) if all_m
        else float("nan"),
        mean_ttft=float(np.mean([m.ttft for m in all_m])) if all_m
        else float("nan"),
        router=getattr(router_obj, "name", str(router)),
        requests_per_node=per_node,
        aborted=aborted,
        migrated=migrated)


# ------------------------------------------------- Fig. 12 overhead probe

def measure_scheduler_overhead(n_nodes: int, rps_per_node: float = 8.0,
                               queue_depth: int = 1000,
                               history_size: int = 10_000,
                               n_probe: int = 200,
                               seed: int = 0,
                               backend: str = "numpy",
                               policy: str = "sagesched",
                               bucket_size: int = 200) -> dict:
    """Wall-clock per-request predict + schedule cost at cluster scale.

    Mirrors the paper's Fig. 12 measurement — a single central scheduler
    handling ``n_nodes * rps_per_node`` RPS with a standing cluster-wide
    queue (depth scaled by load factor, up to ``queue_depth``) and a full
    10k history window — but drives the *real* batched decision path:

      predict stage   ``Scheduler.admit`` — semantic-history predict,
                      cost pushforward, initial priority, row append
                      into the cluster-shared BatchState;
      schedule stage  the per-arrival share of periodic refreshes
                      (~depth/10 rows cross their cost-bucket boundary
                      per arrival interval) recomputed in ONE cluster-
                      wide ``refresh()`` pass through ``backend``, plus
                      the arriving node's dispatch ranking
                      (``order(node_id=...)`` masked lexsort).

    Returns per-request stage latencies in milliseconds.  ``backend``
    picks the priority backend ("object" per-request oracle, "numpy"
    vectorized float64, "cuda" the hand-written CUDA Gittins kernel
    through its staged refresh; float32, so its schedules track numpy's
    to ~1e-5 relative, not bitwise).
    """
    from ..core.policies import make_policy

    rng = np.random.default_rng(seed)
    predictor = SemanticHistoryPredictor()
    # populate the history window
    words = ("alpha beta gamma delta epsilon zeta eta theta iota kappa "
             "lambda mu nu xi omicron pi rho sigma tau upsilon").split()
    prompts = [" ".join(rng.choice(words, size=16)) for _ in range(256)]
    for _ in range(history_size // 256):
        for p in prompts:
            predictor.observe(p, 128, int(rng.integers(50, 2000)))

    sched = Scheduler(predictor=predictor, cost_model=ResourceBoundCost(),
                      policy=make_policy(policy), bucket_size=bucket_size,
                      priority_backend=backend)

    # a standing cluster-wide queue of queue_depth scaled by load factor,
    # requests spread over the nodes round-robin
    load = min(1.0, n_nodes * rps_per_node / (64 * 8.0))
    depth = max(8, int(queue_depth * load))
    ids = []
    for i in range(depth):
        rid = f"q{i}"
        prompt = " ".join(rng.choice(words, size=16))
        sched.admit(rid, prompt, int(rng.integers(16, 1024)),
                    arrival=float(i), node_id=i % n_nodes)
        ids.append(rid)
    gen = np.zeros(depth, np.int64)
    sched.refresh()      # settle the standing queue

    n_refresh = max(1, depth // 10)   # rows crossing a bucket per arrival
    t_pred, t_sched = [], []
    aggregate_rps = n_nodes * rps_per_node
    cursor = 0
    for i in range(n_probe):
        prompt = " ".join(rng.choice(words, size=16))
        node = i % n_nodes
        t0 = time.perf_counter()
        sched.admit(f"p{i}", prompt, 128, arrival=float(depth + i),
                    node_id=node)
        t1 = time.perf_counter()
        # the per-arrival share of periodic refreshes: push a rotating
        # slice of the standing queue across its next bucket boundary,
        # recompute cluster-wide in one batched pass, then rank the
        # arriving node's queue (the dispatch decision)
        take = [(cursor + j) % depth for j in range(n_refresh)]
        gen[take] += bucket_size
        cursor = (cursor + n_refresh) % depth
        sched.on_progress_many([ids[j] for j in take], gen[take])
        sched.refresh()
        sched.order(node_id=node)
        t2 = time.perf_counter()
        sched.on_abort(f"p{i}")  # keep the standing depth constant
        t_pred.append((t1 - t0) * 1e3)
        t_sched.append((t2 - t1) * 1e3)
    return {
        "n_nodes": n_nodes,
        "aggregate_rps": aggregate_rps,
        "queue_depth": depth,
        "backend": backend,
        "policy": policy,
        "refresh_rows_per_arrival": n_refresh,
        "predict_ms": float(np.mean(t_pred)),
        "schedule_ms": float(np.mean(t_sched)),
        "total_ms": float(np.mean(t_pred) + np.mean(t_sched)),
    }
