"""Request queue + admission policy for the continuous-batching engine.

FIFO with bucketed prompt lengths: the queue is strictly arrival-ordered;
when decode slots free up, admission takes the oldest *arrived* request,
derives its prompt-length bucket, and greedily collects further arrived
requests of the same bucket (in FIFO order) up to the free-slot count — so
one compiled prefill step serves the whole join and the decode pool refills
in a single scatter. Requests of other buckets keep their queue position.

Buckets are powers of two by default (one compiled prefill per bucket,
right-padding handled by ``models.api.prefill_bucketed``). Families with
recurrent mixers (mamba / xlstm) get *exact-length* buckets: padding would
flow through the recurrent state, so those prompts only share a prefill with
equal-length peers.

Eviction policy lives here too (:meth:`Scheduler.should_finish`): a request
retires on EOS or on reaching ``max_new_tokens``, freeing its slot for the
next join without touching any other lane.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

from repro_torch.configs.base import ArchConfig

__all__ = [
    "Request",
    "RequestState",
    "Scheduler",
    "bucket_length",
    "gen_len_spread",
    "poisson_trace",
    "shared_prefix_trace",
]


# Process-wide monotonic uid source: `rid` is the caller's name for a
# request (benchmarks reuse the same rids across warmup/timed replays), so
# per-request telemetry keys on `uid` instead — unique across every Request
# ever constructed in this process.
_UIDS = itertools.count(1)


@dataclasses.dataclass
class Request:
    """One serving request. ``arrival`` is in scheduler clock ticks (one tick
    per engine decode step), so traces replay deterministically. ``uid`` is
    assigned monotonically at construction and is the stable key every
    per-request record carries."""

    rid: int
    prompt: Sequence[int]
    max_new_tokens: int
    arrival: int = 0
    uid: int = dataclasses.field(default_factory=lambda: next(_UIDS))

    def __post_init__(self) -> None:
        if not len(self.prompt):
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens < 1")


@dataclasses.dataclass
class RequestState:
    """Per-request tracking while (and after) a request holds a slot.

    ``n_emitted`` counts sampled tokens; ``tokens`` holds their values. The
    engine's pipelined path defers fetching values to the end of the run, so
    ``n_emitted`` can run ahead of ``len(tokens)`` mid-flight.
    """

    request: Request
    slot: int
    joined_at: int  # engine step of the join
    tokens: List[int] = dataclasses.field(default_factory=list)
    n_emitted: int = 0
    finished_at: Optional[int] = None

    @property
    def done(self) -> bool:
        return self.finished_at is not None

    @property
    def uid(self) -> int:
        return self.request.uid


def bucket_length(
    n: int, *, exact: bool = False, minimum: int = 8,
    maximum: Optional[int] = None,
) -> int:
    """Prompt-length -> bucket: next power of two, floored at ``minimum`` and
    clamped to ``maximum`` (the pool's max_len — a bucket longer than the KV
    buffers could never scatter in)."""
    if exact:
        return n
    b = minimum
    while b < n:
        b *= 2
    if maximum is not None:
        b = min(b, maximum)
    return max(b, n)


def _has_recurrent(cfg: ArchConfig) -> bool:
    return any(bd.mixer in ("mamba", "mlstm", "slstm") for bd in cfg.pattern)


class Scheduler:
    """FIFO queue with bucketed-prompt admission and EOS/max-token eviction."""

    def __init__(
        self,
        cfg: ArchConfig,
        *,
        eos_id: Optional[int] = None,
        exact_buckets: Optional[bool] = None,
        min_bucket: int = 8,
        max_bucket: Optional[int] = None,
    ) -> None:
        self.cfg = cfg
        self.eos_id = eos_id
        # Padding flows through recurrent state, so mamba/xlstm families
        # only batch prompts of identical length into one prefill.
        self.exact_buckets = (
            _has_recurrent(cfg) if exact_buckets is None else exact_buckets
        )
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        self._queue: Deque[Request] = deque()
        self.states: Dict[int, RequestState] = {}  # rid -> state
        # Admission side-channel for the engine's tracer: set by every
        # next_batch() that returns a batch — {"bucket": join bucket,
        # "fallthrough": head was blocked and admission fell through to a
        # deeper bucket}; None when the last call returned [].
        self.last_admission: Optional[Dict[str, object]] = None

    # -- queue -------------------------------------------------------------

    def submit(self, request: Request) -> None:
        if request.rid in self.states or any(
            r.rid == request.rid for r in self._queue
        ):
            raise ValueError(f"duplicate request id {request.rid}")
        self._queue.append(request)

    def __len__(self) -> int:
        return len(self._queue)

    def n_arrived(self, now: int) -> int:
        return sum(1 for r in self._queue if r.arrival <= now)

    @property
    def drained(self) -> bool:
        """True when the queue is empty and every admitted request finished."""
        return not self._queue and all(s.done for s in self.states.values())

    def bucket(self, prompt_len: int) -> int:
        return bucket_length(
            prompt_len, exact=self.exact_buckets, minimum=self.min_bucket,
            maximum=self.max_bucket,
        )

    # -- admission ---------------------------------------------------------

    def next_batch(
        self, max_n: int, now: int, admissible=None
    ) -> List[Request]:
        """Pop up to ``max_n`` arrived requests sharing one bucket.

        The head-of-line request keeps strict FIFO priority whenever it is
        admissible: the join bucket is then the head's, and same-bucket
        arrivals ride along. But admitting *only* from the literal head
        starved whole buckets: with the head un-admittable (e.g. its prompt
        needs a pipeline stage that is full), arrived requests in every
        other bucket waited behind it while slots sat free. With the head
        blocked, admission now falls through to the **deepest non-empty
        admissible bucket** (longest prompts first — they have the most
        remaining work to pipeline); skipped requests keep their queue
        position.

        ``admissible`` is an optional ``Request -> bool`` predicate supplied
        by the engine (e.g. "this prompt's remaining prefill fits the chunk
        pipeline right now"). Returns [] when nothing admissible has arrived
        or no slot is free.
        """
        self.last_admission = None
        if max_n <= 0:
            return []
        ok = admissible if admissible is not None else (lambda r: True)
        head = next((r for r in self._queue if r.arrival <= now), None)
        if head is None:
            return []
        fallthrough = not ok(head)
        if not fallthrough:
            want = self.bucket(len(head.prompt))
        else:
            candidates = [
                r for r in self._queue if r.arrival <= now and ok(r)
            ]
            if not candidates:
                return []
            want = max(self.bucket(len(r.prompt)) for r in candidates)
        batch: List[Request] = []
        for r in list(self._queue):
            if len(batch) >= max_n:
                break
            if (
                r.arrival <= now
                and self.bucket(len(r.prompt)) == want
                and ok(r)
            ):
                batch.append(r)
                self._queue.remove(r)
        if batch:
            self.last_admission = {"bucket": want, "fallthrough": fallthrough}
        return batch

    def admit(self, requests: List[Request], slots: List[int], now: int) -> None:
        for r, s in zip(requests, slots):
            self.states[r.rid] = RequestState(request=r, slot=s, joined_at=now)

    # -- eviction ----------------------------------------------------------

    def record_token(self, rid: int, token: int, now: int) -> bool:
        """Append a sampled token; returns True when the request retires."""
        st = self.states[rid]
        st.tokens.append(token)
        st.n_emitted += 1
        if self.should_finish(st, token):
            st.finished_at = now
            return True
        return False

    def record_emitted(self, rid: int, now: int) -> bool:
        """Count an emitted token whose value is fetched later (pipelined
        path, only valid without EOS eviction); True when the request
        retires on its max-token budget."""
        assert self.eos_id is None
        st = self.states[rid]
        st.n_emitted += 1
        if st.n_emitted >= st.request.max_new_tokens:
            st.finished_at = now
            return True
        return False

    def should_finish(self, st: RequestState, token: int) -> bool:
        if self.eos_id is not None and token == self.eos_id:
            return True
        return st.n_emitted >= st.request.max_new_tokens


def gen_len_spread(max_gen: int):
    """Small spread of generation budgets for demo traces, all <= max_gen
    (so ``prompt + budget <= prompt + max_gen`` sizing always holds)."""
    return tuple(sorted({max(1, max_gen // 4), max(1, max_gen // 2), max_gen}))


def poisson_trace(
    n_requests: int,
    *,
    seed: int = 0,
    vocab: int = 256,
    prompt_lens: Sequence[int] = (6, 12, 17, 24, 32),
    gen_lens: Sequence[int] = (4, 8, 12, 24, 48),
    mean_interarrival: float = 0.0,
) -> List[Request]:
    """Deterministic mixed-length request trace with Poisson-ish arrivals.

    Arrival gaps are exponential with mean ``mean_interarrival`` (in decode
    steps; 0 = a burst that saturates the pool immediately). Prompt tokens,
    lengths, and generation budgets are drawn from a seeded generator so the
    same trace drives the static and continuous engines in the benchmark.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for rid in range(n_requests):
        if mean_interarrival > 0:
            t += rng.exponential(mean_interarrival)
        plen = int(rng.choice(prompt_lens))
        out.append(
            Request(
                rid=rid,
                prompt=[int(x) for x in rng.integers(0, vocab, plen)],
                max_new_tokens=int(rng.choice(gen_lens)),
                arrival=int(t),
            )
        )
    return out


def shared_prefix_trace(
    n_requests: int,
    *,
    seed: int = 0,
    vocab: int = 256,
    prefix_len: int = 96,
    tail_lens: Sequence[int] = (8, 12, 16),
    gen_lens: Sequence[int] = (4, 8, 12),
    mean_interarrival: float = 0.0,
) -> List[Request]:
    """Poisson-ish trace where every prompt opens with one shared system
    prompt of ``prefix_len`` tokens followed by a unique per-request tail —
    the chat-serving shape the prefix cache exists for. Request 0 pays the
    cold prefill; once its blocks are inserted, every later join resumes
    from the cached prefix and chunk-prefills only its tail."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prefix = [int(x) for x in rng.integers(0, vocab, prefix_len)]
    t = 0.0
    out = []
    for rid in range(n_requests):
        if mean_interarrival > 0:
            t += rng.exponential(mean_interarrival)
        tail_len = int(rng.choice(tail_lens))
        tail = [int(x) for x in rng.integers(0, vocab, tail_len)]
        out.append(
            Request(
                rid=rid,
                prompt=prefix + tail,
                max_new_tokens=int(rng.choice(gen_lens)),
                arrival=int(t),
            )
        )
    return out
