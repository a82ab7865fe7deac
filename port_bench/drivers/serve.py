"""The multi-tenant PUD integrity service under closed-loop tenants.

``repro_torch.serve.PudService`` with the configuration's settings,
driven through ``start()`` / ``submit()`` on one asyncio loop.  Tenant
``i`` keeps one request of each kind the traffic gives it in flight, one
closed-loop client a kind, which sends its next request when its reply
arrives.  Heal and verify tiles come from a pool made at set-up from the
seed; each request draws its tile from the pool by the seed.

The benchmark wraps a few of the service's methods on this instance to
read what it already measures (a batch's wall as ``SloMonitor`` records
it, each request's ``queued`` span) and to mark host spans for the trace
(``serve.tick``, ``serve.batch.<kind>``); the wrappers change no result.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np
import torch
from torch.profiler import record_function

from port_bench.harness import peaks
from port_bench.harness.record import Record
from port_bench.harness.runner import Check
from port_bench.harness.spec import reference
from port_bench.harness.traffic import Reservoir, pool_order, sub_seed, \
    tenants

KINDS = ("erase", "heal", "verify")


def flip_bits(words: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """A copy of ``words`` with the distinct flat bit positions ``pos``
    flipped."""
    out = words.copy()
    np.bitwise_xor.at(out.reshape(-1), pos // 32,
                      (np.uint32(1) << (pos % 32)).astype(np.uint32))
    return out


def make_pool(traffic: dict, words: int, seed: int, device: str) -> dict:
    """Heal replicas and verify pairs, random words drawn on the device in
    one call a kind.  Entry ``j`` of the heal pool has one word of replica
    ``j % replicas``, at a row and column drawn from the seed, XORed with
    ``heal_xor``; entry ``j`` of the verify pool differs from its
    reference in ``lo + step * (j % span)`` bits."""
    rows, x = int(traffic["tile_rows"]), int(traffic["replicas"])
    n_heal, n_verify = (int(traffic["pool"].get(k, 0))
                        for k in ("heal", "verify"))
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 0x706F6F6C))

    def draw(n):
        t = torch.randint(-2**31, 2**31, (n, rows, words),
                          dtype=torch.int32, device=device, generator=gen)
        return t.cpu().numpy().view(np.uint32)

    rng = np.random.default_rng(sub_seed(seed, 0x666C6970))
    heal = []
    if n_heal:
        clean = draw(n_heal)
        for j in range(n_heal):
            reps = np.stack([clean[j]] * x)
            reps[j % x, rng.integers(rows), rng.integers(words)] ^= \
                np.uint32(traffic["heal_xor"])
            heal.append(reps)
        del clean
    verify = []
    if n_verify:
        v_lo, v_hi = traffic["verify_flips"]
        span = int(traffic["verify_span"])
        step = (v_hi - v_lo) // (span - 1)
        live = draw(n_verify)
        n_bits = rows * words * 32
        verify = [(live[j], flip_bits(live[j], rng.choice(
            n_bits, v_lo + step * (j % span), replace=False)))
            for j in range(n_verify)]
    return {"heal": heal, "verify": verify}


class State:
    def __init__(self, config, traffic, seed, device):
        from repro_torch.backends import ExecutionContext
        from repro_torch.serve import PudService, ServiceConfig

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.words = int(config["words"])
        self.svc = PudService(ServiceConfig(
            backend=config["backend"],
            ctx=ExecutionContext(ideal=True, device=device),
            pool_size=int(config["pool_size"]),
            max_batch=int(config["max_batch"]),
            coalesce=bool(config["coalesce"]),
            queue_depth=int(config["queue_depth"]),
            tenant_rows=int(config["tenant_rows"]),
            tick_window_s=float(config["tick_window_s"])))
        self.pool = {}
        self.answers = None
        self.reset()
        self._wrap()

    def reset(self):
        self.batch_s: list[float] = []
        self.queued_s: list[float] = []
        self.maj_bytes = 0

    def _wrap(self):
        svc = self.svc
        record_batch = svc.slo.record_batch
        record_completion = svc.slo.record_completion
        execute = svc.batcher.execute
        tick = svc.tick

        def on_batch(n, wall_s, *args, **kw):
            self.batch_s.append(wall_s)
            return record_batch(n, wall_s, *args, **kw)

        def on_completion(trace):
            self.queued_s.extend(s.duration_s for s in trace.spans
                                 if s.name == "queued")
            return record_completion(trace)

        def traced_execute(plan, session):
            with record_function(f"serve.batch.{plan.kind}"):
                return execute(plan, session)

        def traced_tick():
            with record_function("serve.tick"):
                return tick()

        svc.slo.record_batch = on_batch
        svc.slo.record_completion = on_completion
        svc.batcher.execute = traced_execute
        svc.tick = traced_tick
        for session in svc.sessions:
            session.run_fused = self._counted(session.run_fused)

    def _counted(self, run_fused):
        def run(program, state, **kw):
            self.maj_bytes += peaks.maj_op_bytes(program,
                                                 int(state.shape[1]))
            return run_fused(program, state, **kw)
        return run

    def request(self, kind: str, j: int, tenant: str):
        from repro_torch import serve

        t = self.traffic
        if kind == "heal":
            return serve.HealRequest(replicas=self.pool["heal"][j],
                                     tenant=tenant)
        if kind == "verify":
            live, ref = self.pool["verify"][j]
            return serve.IntegrityRequest(live=live, reference=ref,
                                          tenant=tenant)
        return serve.EraseRequest(rows=int(t["erase_rows"]),
                                  words=self.words,
                                  pattern=int(t["pattern"]),
                                  fanout=int(t["erase_fanout"]),
                                  tenant=tenant)


async def _drive(st: State, t_end=None, per_client=None, keep=None):
    """Every tenant's closed loop until ``t_end`` (or ``per_client``
    requests each); returns (latencies, failed, last reply time)."""
    from repro_torch.serve.admission import (AdmissionError,
                                             DeadlineExceededError)

    svc = st.svc
    latencies: list[float] = []
    failed = 0
    last = [0.0]
    pools = {k: len(st.pool.get(k, ())) for k in KINDS}

    async def client(kind: str, i: int):
        nonlocal failed
        order = pool_order(max(pools[kind], 1), st.seed, KINDS.index(kind),
                           i)
        sent = 0
        while (per_client is None or sent < per_client) and \
                (t_end is None or time.perf_counter() < t_end):
            with record_function("bench.submit"):
                j = next(order)
                req = st.request(kind, j, f"tenant{i}")
            t = time.perf_counter()
            sent += 1
            try:
                res = await svc.submit(req)
            except (AdmissionError, DeadlineExceededError):
                failed += 1
                continue
            now = time.perf_counter()
            latencies.append(now - t)
            last[0] = max(last[0], now)
            if keep is not None:
                keep(kind, j, res)

    await svc.start()
    try:
        await asyncio.gather(*[client(k, i) for k, i in
                               tenants(st.traffic["tenants"])])
    finally:
        await svc.stop()
    return latencies, failed, last[0]


def setup(config: dict, traffic: dict, seed: int, device: str,
          split: dict) -> State:
    t = time.perf_counter()
    st = State(config, traffic, seed, device)
    st.pool = make_pool(traffic, st.words, seed, device)
    split["pool"] = time.perf_counter() - t
    # The first round compiles, certifies and caches each coalesced
    # Program of the window's shape; the second finds all of it built.
    for phase in ("certify", "warm"):
        t = time.perf_counter()
        asyncio.run(_drive(st, per_client=1))
        split[phase] = time.perf_counter() - t
    return st


def window(st: State, seconds: float, prof) -> Record:
    st.reset()
    if st.answers is None:  # one sample over every window of the run
        k = int(st.traffic["sample_tiles"])
        st.answers = {"counts": {"heal": [], "verify": [], "erase": 0},
                      "tiles": {"heal": Reservoir(k, st.seed, 1),
                                "erase": Reservoir(k, st.seed, 2)}}
    counts, tiles = st.answers["counts"], st.answers["tiles"]

    def keep(kind, j, res):
        if kind == "verify":
            counts["verify"].append((j, res.mismatch_bits))
        elif kind == "heal":
            counts["heal"].append((j, res.fixed_bits))
            tiles["heal"].offer(lambda: (j, res.healed.clone()))
        else:
            counts["erase"] += 1
            tiles["erase"].offer(lambda: (j, res.wiped.clone()))

    with record_function("bench.window"):
        t_start = time.perf_counter()
        latencies, failed, t_last = asyncio.run(
            _drive(st, t_end=t_start + seconds, keep=keep))
    n = len(latencies)
    return Record(
        window_s=t_last - t_start, attempted=n + failed, failed=failed,
        latencies_s=latencies, work={"requests": n},
        host={"batch_s": list(st.batch_s), "queued_s": list(st.queued_s)},
        counters={"maj_bytes": st.maj_bytes, "words": st.words})


def release(st: State) -> dict:
    """The answers on the host; the service and its sessions dropped."""
    ans = st.answers
    tiles = {kind: [(j, t.cpu().numpy().view(np.uint32))
                    for j, t in r.items]
             for kind, r in ans["tiles"].items()}
    st.svc = None
    st.answers = None
    return {"pool": st.pool, "counts": ans["counts"], "tiles": tiles,
            "words": st.words}


def check(answers: dict, config: dict, traffic: dict, seed: int
          ) -> list[Check]:
    """Every verify count and heal fix count, and the sampled heal and
    erase tiles, against the plain reference."""
    ref = reference(config)
    pool = answers["pool"]
    counts = answers["counts"]
    fixed = {}
    heal_tile_bits = 0
    for j, got in answers["tiles"]["heal"]:
        heal_tile_bits += ref.tile_bits_wrong(ref.heal(pool["heal"][j]),
                                              got)
    heal_fixed = 0
    for j, got in counts["heal"]:
        if j not in fixed:
            fixed[j] = ref.fixed_bits(pool["heal"][j])
        heal_fixed += got != fixed[j]
    want_erase = ref.erase(int(traffic["erase_rows"]), answers["words"],
                           int(traffic["pattern"]))
    erase_words = sum(ref.words_wrong(want_erase, got)
                      for _, got in answers["tiles"]["erase"])
    verify = {}
    verify_wrong = 0
    for j, got in counts["verify"]:
        if j not in verify:
            verify[j] = ref.verify(*pool["verify"][j])
        verify_wrong += got != verify[j]
    compared = {"heal": len(counts["heal"]) and
                len(answers["tiles"]["heal"]),
                "erase": len(answers["tiles"]["erase"]),
                "verify": len(counts["verify"])}
    sent = [k for k, n in traffic["tenants"].items() if n]
    return [Check("heal_tile_bits_wrong", heal_tile_bits, 0),
            Check("heal_fixed_bits_wrong", heal_fixed, 0),
            Check("erase_words_wrong", erase_words, 0),
            Check("verify_counts_wrong", verify_wrong, 0),
            Check("kinds_not_compared",
                  sum(1 for k in sent if not compared[k]), 0)]
