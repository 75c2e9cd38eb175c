"""Continuous-batching scheduler: request lifecycle + slot bookkeeping.

Copied whole from ``repro/serving/scheduler.py`` (stdlib only; importing
it from ``repro`` would pull in jax through ``repro.serving``).

Pure host-side logic so it unit-tests in microseconds.  The engine
owns the device state (decode cache, token buffer, per-slot PRNG keys); this
module owns *which request lives in which slot and when*:

    QUEUED ──admit──▶ PREFILL ──start_decode──▶ DECODE ──evict──▶ DONE
       ▲  priority-ordered,                        │ EOS hit, budget,
       └─ into the lowest free slot                │ deadline, NaN, or
          (mid-flight refill;                      ▼ preemption kill
          requeue() puts a preempted                 frees the slot
          request back at its class head)

Admission is priority-ordered (lower ``priority`` wins; rid breaks ties, so
traffic of a single class is strictly FIFO over submit order); a freed slot
is refilled from the queue head on the next ``admit()`` call, while the
other slots keep decoding — that mid-flight refill is what lifts slot
occupancy over static batching on mixed-length traces.  A preempted request
leaves its slot via :meth:`requeue` (back to QUEUED, same rid — so it heads
its class) and a queued request can be killed without ever owning a slot
via :meth:`cancel`; :meth:`expired` is the deadline view the engine's
deadline pass evicts from.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import hashlib
from typing import Any, Callable, Optional, Sequence


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"


# Priority classes: LOWER values are MORE urgent.  Interactive traffic
# (chat turns, short completions) overtakes batch jobs at admission and may
# preempt them when the block pool is exhausted.
PRIORITY_INTERACTIVE = 0
PRIORITY_BATCH = 1

# Every terminal ``done_reason`` the scheduler/engine can stamp.  "eos" and
# "length" are natural completions; the rest are evictions: a missed
# deadline, a logit-sanity trip ("nan" non-finite, "saturated" finite but
# over the analog rail, "entropy_collapse" distribution pinned to one
# token — the detection codes of the degraded-device loop), or an
# injected/administrative kill.
EVICT_REASONS = (
    "eos", "length", "deadline", "nan", "saturated", "entropy_collapse",
    "preempted",
)


def left_pad(prompt: Sequence[int], length: int, pad: int = 0) -> list[int]:
    """Right-align ``prompt`` in a window of ``length`` (pad on the left).

    Left padding keeps the last prompt token — the one whose logits seed
    decoding — at a fixed position, so prefill of a short prompt and a long
    prompt produce caches with the same alignment contract.
    """
    if len(prompt) > length:
        raise ValueError(f"prompt len {len(prompt)} > window {length}")
    return [pad] * (length - len(prompt)) + list(prompt)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None         # live binding; None once DONE
    output: list[int] = dataclasses.field(default_factory=list)
    done_reason: Optional[str] = None  # "eos" | "length"
    # the slot this request occupied while live, recorded at eviction —
    # the historical value for metrics/debugging.  ``slot`` itself is
    # nulled when the request leaves its slot, so a late reader can never
    # silently index per-slot state that now belongs to the NEXT request
    # admitted into the same slot.
    done_slot: Optional[int] = None
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    done_time: Optional[float] = None
    # scheduling class: lower is more urgent (PRIORITY_INTERACTIVE beats
    # PRIORITY_BATCH at admission and may preempt it under pool pressure)
    priority: int = PRIORITY_BATCH
    # wall-clock completion SLO in milliseconds from submit_time; None
    # disables the deadline pass for this request
    deadline_ms: Optional[float] = None
    # how many times this request was preempted (spilled + requeued)
    preemptions: int = 0
    # self-speculative decoding state (paged engine, speculate_k > 0):
    # draft tokens this request's slot put through acceptance, how many
    # were accepted verbatim, and the dirty high-water mark — the highest
    # absolute position a draft run has WRITTEN K/V into, which may run
    # ahead of ``pos`` after a rejection (those rows are masked dead
    # weight until decode reaches them again); always within the
    # request's block reservation plus the trash page
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_high: int = 0

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time


def prefix_block_hashes(
    padded_prompt: Sequence[int], block_size: int
) -> list[tuple[bytes, int]]:
    """Chain hashes of a padded prompt's KV blocks.

    Block ``i`` of a paged cache holds logical positions
    ``[i·block_size, (i+1)·block_size)``, so its K/V content is fully
    determined by the padded prompt tokens up to and including that block
    (positions are absolute — RoPE makes content position-dependent).  The
    chain digest ``h_i = H(h_{i-1} || n_tokens || tokens_i)`` therefore
    identifies *content at position*: two requests share block ``i`` iff
    their padded prompts agree on every token before ``(i+1)·block_size``.
    The trailing block of an unaligned prompt hashes only the tokens it
    actually holds (``n_tokens`` disambiguates it from a full block).

    Returns one ``(digest, seed)`` pair per block covering the padded
    prompt; ``seed`` is a uint32 derived from the digest, used as the
    canonical stochastic-rounding seed when the block is quantized to int8
    (content-derived, NOT request-derived, so re-prefills of the same
    prefix produce bit-identical codes and the blocks stay shareable).
    """
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    out: list[tuple[bytes, int]] = []
    h = b"raca-prefix-v1"
    n = len(padded_prompt)
    for start in range(0, n, block_size):
        toks = padded_prompt[start : start + block_size]
        m = hashlib.blake2b(digest_size=16)
        m.update(h)
        m.update(len(toks).to_bytes(4, "little"))
        for t in toks:
            m.update(int(t).to_bytes(8, "little", signed=True))
        h = m.digest()
        out.append((h, int.from_bytes(h[:4], "little")))
    return out


class BlockAllocator:
    """Refcounted free-list allocator over a fixed pool of KV-cache blocks,
    with a content-hash prefix index for block sharing.

    Pure host bookkeeping for the paged cache: the engine reserves a
    request's whole block budget at admission (prefill blocks + decode
    budget blocks, so a decoding request can never run out mid-flight) and
    releases it on eviction.  Block 0 is reserved as the *trash page*:
    evicted slots' table rows point at it, so the decode step's writes from
    idle slots land somewhere no live request ever reads.

    Prefix sharing: an allocated page may be *registered* under the chain
    hash of the prompt block it holds (:func:`prefix_block_hashes`).  A
    later admission whose prompt chain matches maps the resident page into
    its own table (``reserve(shared=...)`` bumps the refcount) instead of
    taking a fresh page.  Pages return to the free list only when their
    refcount reaches zero, at which point their index entry (and any
    payload attached to it) is dropped — the index can never hand out a
    freed or recycled page.  A ``spare`` page can be reserved alongside as
    the copy-on-write fork target for a shared block the request will
    write into (:meth:`cow_fork`).

    Index entries may carry an opaque ``payload`` (the engine stores the
    original prefill's last-token logits + per-slot state leaves there, so
    a full-prompt hit can skip its prefill entirely); the allocator never
    inspects payloads, keeping this module host-only logic.
    """

    def __init__(self, n_blocks: int, n_reserved: int = 1):
        if n_blocks <= n_reserved:
            raise ValueError(
                f"pool of {n_blocks} blocks leaves nothing to allocate "
                f"after {n_reserved} reserved"
            )
        self.n_blocks = n_blocks
        self.n_reserved = n_reserved
        # pop() from the tail → lowest-numbered pages are handed out first
        self._free = list(range(n_blocks - 1, n_reserved - 1, -1))
        self._refs: dict[int, int] = {}          # page -> refcount (>= 1)
        self._owned: dict[int, list[int]] = {}   # owner -> mapped pages
        self._spare: dict[int, list[int]] = {}   # owner -> COW fork targets
        self._prefix: dict[bytes, int] = {}      # chain hash -> page
        self._page_hash: dict[int, bytes] = {}   # page -> its chain hash
        self._payload: dict[bytes, Any] = {}     # chain hash -> opaque data

    @property
    def capacity(self) -> int:
        """Allocatable blocks (excludes reserved pages)."""
        return self.n_blocks - self.n_reserved

    @property
    def available(self) -> int:
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def refcount(self, page: int) -> int:
        """How many owners reference ``page`` (0 = free/reserved)."""
        return self._refs.get(page, 0)

    def reserve(
        self,
        owner: int,
        n_new: int,
        shared: Sequence[int] = (),
        n_spare: int = 0,
    ) -> list[int]:
        """Atomically take a request's whole block budget at admission.

        ``shared`` pages (matched through the prefix index) get a refcount
        bump and lead the owner's mapped list, in table order; ``n_new``
        fresh pages follow; ``n_spare`` additional fresh pages are held
        unmapped as guaranteed COW fork targets.  Either everything is
        taken or nothing is (pool exhaustion raises before any state
        changes), so an admission gate's True answer can never leak a
        partial reservation.  Returns the mapped pages (shared + fresh).
        """
        if n_new < 0 or n_spare < 0:
            raise ValueError(f"negative reservation ({n_new}, {n_spare})")
        if not shared and n_new + n_spare < 1:
            raise ValueError("empty reservation")
        if owner in self._owned:
            raise ValueError(f"owner {owner} already holds blocks")
        if n_new + n_spare > len(self._free):
            raise ValueError(
                f"pool exhausted: want {n_new + n_spare}, "
                f"have {len(self._free)}"
            )
        if len(set(shared)) != len(shared):
            # a duplicated shared page would be double-mapped into one
            # owner's table AND double-refcounted — free() would then
            # decref it twice for a single logical mapping
            dupes = sorted(
                {p for p in shared if list(shared).count(p) > 1}
            )
            raise ValueError(f"duplicate shared page(s) {dupes}")
        for p in shared:
            if p not in self._refs:
                raise ValueError(f"cannot share unallocated page {p}")
        for p in shared:
            self._refs[p] += 1
        fresh = [self._free.pop() for _ in range(n_new)]
        spare = [self._free.pop() for _ in range(n_spare)]
        for p in fresh + spare:
            self._refs[p] = 1
        self._owned[owner] = list(shared) + fresh
        self._spare[owner] = spare
        return list(self._owned[owner])

    def alloc(self, owner: int, n: int) -> list[int]:
        """Take ``n`` fresh blocks for ``owner`` (the no-sharing path)."""
        if n < 1:
            raise ValueError(f"need at least one block, got {n}")
        return self.reserve(owner, n)

    def _decref(self, page: int) -> bool:
        """Drop one reference; True if the page went back to the free list."""
        self._refs[page] -= 1
        if self._refs[page] > 0:
            return False
        del self._refs[page]
        self.deregister(page)
        self._free.append(page)
        return True

    def free(self, owner: int) -> int:
        """Release ``owner``'s references (mapped + spare pages).

        Returns how many pages actually went back to the pool — shared
        pages survive until their LAST owner releases them (refcount
        zero), which is the whole point of refcounting.
        """
        pages = self._owned.pop(owner)
        pages = pages + self._spare.pop(owner, [])
        return sum(self._decref(p) for p in reversed(pages))

    def owned(self, owner: int) -> list[int]:
        return list(self._owned.get(owner, []))

    def spare_count(self, owner: int) -> int:
        return len(self._spare.get(owner, []))

    def cow_fork(self, owner: int, idx: int) -> tuple[int, int]:
        """Repoint ``owner``'s mapped block ``idx`` at a reserved spare page.

        The copy-on-write fork: called by the engine just before ``owner``
        first writes into a block it shares.  The old page loses one
        reference (it stays alive for — and registered to — its other
        owners); the spare becomes the private replacement.  Returns
        ``(old_page, new_page)`` so the engine can issue the device-side
        page copy and repoint its table row.
        """
        old = self._owned[owner][idx]
        if self._refs.get(old, 0) < 2:
            raise ValueError(
                f"COW fork of page {old} with refcount "
                f"{self._refs.get(old, 0)} — nothing is shared"
            )
        if not self._spare.get(owner):
            raise ValueError(f"owner {owner} reserved no spare fork page")
        new = self._spare[owner].pop()
        self._owned[owner][idx] = new
        self._refs[old] -= 1
        return old, new

    # -- content-hash prefix index ------------------------------------------

    def register(self, page: int, h: bytes, payload: Any = None) -> None:
        """Publish ``page`` as holding the prompt block with chain hash
        ``h``; later admissions matching ``h`` share it via ``reserve``."""
        if page not in self._refs:
            raise ValueError(f"cannot register unallocated page {page}")
        if h in self._prefix:
            raise ValueError(f"hash already registered to page {self._prefix[h]}")
        if page in self._page_hash:
            raise ValueError(f"page {page} already registered")
        self._prefix[h] = page
        self._page_hash[page] = h
        if payload is not None:
            self._payload[h] = payload

    def lookup(self, h: bytes) -> Optional[int]:
        """Resident page holding the block hashed ``h``, or None."""
        return self._prefix.get(h)

    def longest_prefix_match(self, hashes: Sequence[bytes]) -> list[int]:
        """Deepest resident chain hit for a prompt's block hashes.

        Walks ``hashes`` (one chain digest per prompt block, in table
        order) and returns the pages of the longest *consecutive* leading
        run that is resident in the prefix index — the match an admission
        maps into its block table.  Chain digests make consecutiveness
        structural (block ``i``'s hash commits to everything before it),
        so the first miss ends the usable prefix.  Read-only: probing
        never bumps a refcount or touches the index — only a subsequent
        ``reserve(shared=...)`` takes references, and atomically.
        """
        pages: list[int] = []
        for h in hashes:
            page = self._prefix.get(h)
            if page is None:
                break
            pages.append(page)
        return pages

    def payload(self, h: bytes) -> Any:
        return self._payload.get(h)

    def set_payload(self, h: bytes, payload: Any) -> None:
        if h not in self._prefix:
            raise ValueError("cannot attach payload to unregistered hash")
        self._payload[h] = payload

    def deregister(self, page: int) -> None:
        """Drop ``page``'s index entry (content diverged or page freed).

        Idempotent: unregistered pages are a no-op, so the engine can call
        it unconditionally before an in-place write.
        """
        h = self._page_hash.pop(page, None)
        if h is not None:
            self._prefix.pop(h, None)
            self._payload.pop(h, None)

    def registered_pages(self) -> dict[int, bytes]:
        """page -> hash view of the prefix index (tests/debugging)."""
        return dict(self._page_hash)


class Scheduler:
    """Slot table + FIFO queue; single-threaded, driven by the engine."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self._queue: collections.deque[Request] = collections.deque()
        self._slots: list[Optional[Request]] = [None] * n_slots
        self._requests: dict[int, Request] = {}
        self._next_rid = 0

    # -- submission / admission --------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        now: float = 0.0,
        priority: int = PRIORITY_BATCH,
        deadline_ms: Optional[float] = None,
    ) -> Request:
        req = Request(
            rid=self._next_rid,
            prompt=list(prompt),
            max_new_tokens=int(max_new_tokens),
            submit_time=now,
            priority=int(priority),
            deadline_ms=None if deadline_ms is None else float(deadline_ms),
        )
        self._next_rid += 1
        self._requests[req.rid] = req
        self._queue.append(req)
        return req

    def peek(self) -> Optional[Request]:
        """The request :meth:`admit` would try next (priority head)."""
        if not self._queue:
            return None
        return min(self._queue, key=lambda r: (r.priority, r.rid))

    def admit(
        self,
        gate: Optional[Callable[[Request], bool]] = None,
        shed_priority_above: Optional[int] = None,
    ) -> list[Request]:
        """Move queued requests into free slots (priority order, lowest
        slot first).

        The queue head is the most-urgent queued request — lowest
        ``priority``, rid breaking ties, so single-class traffic is
        strictly FIFO and a requeued (preempted) request resumes at the
        head of its class.  ``gate``, when given, is asked per queue-head
        request whether it can be admitted right now (the paged engine's
        block-pool back-pressure).  A gated-out head STOPS admission —
        skipping ahead would break the ordering and could starve large
        requests behind a stream of small ones.  The request simply stays
        QUEUED for a later ``admit()``.

        ``shed_priority_above``, when given, refuses admission to any head
        whose priority is strictly less urgent (numerically greater) —
        the degradation ladder's load-shedding rung: under sustained fault
        pressure batch-class traffic waits in queue while interactive
        traffic keeps flowing.  Because the head is the MOST urgent queued
        request, stopping at a shed head never skips an admissible one.

        Returns the newly admitted requests, now in PREFILL state; the
        engine must prefill each and call :meth:`start_decode`.
        """
        admitted = []
        for slot in range(self.n_slots):
            if not self._queue:
                break
            if self._slots[slot] is not None:
                continue
            head = min(self._queue, key=lambda r: (r.priority, r.rid))
            if (
                shed_priority_above is not None
                and head.priority > shed_priority_above
            ):
                break
            if gate is not None and not gate(head):
                break
            self._queue.remove(head)
            head.state = RequestState.PREFILL
            head.slot = slot
            self._slots[slot] = head
            admitted.append(head)
        return admitted

    def start_decode(self, req: Request) -> None:
        assert req.state is RequestState.PREFILL, req.state
        req.state = RequestState.DECODE

    # -- token accounting / eviction ---------------------------------------

    def record_token(
        self, req: Request, token: int, eos_token: int, now: float = 0.0
    ) -> bool:
        """Append one generated token; evict on EOS / length.  True if done.

        ``eos_token < 0`` (the default -1) disables early stopping — real
        token ids are non-negative, so -1 can never match.
        """
        assert req.state is RequestState.DECODE, req.state
        if req.first_token_time is None:
            req.first_token_time = now
        req.output.append(int(token))
        if eos_token >= 0 and int(token) == eos_token:
            self.evict(req, "eos", now)
            return True
        if len(req.output) >= req.max_new_tokens:
            self.evict(req, "length", now)
            return True
        return False

    def evict(self, req: Request, reason: str, now: float = 0.0) -> None:
        assert req.slot is not None
        self._slots[req.slot] = None
        req.state = RequestState.DONE
        req.done_reason = reason
        req.done_time = now
        # sever the live slot binding: the next admission reuses this
        # slot, and a DONE request that kept aliasing it would let any
        # late reader (metrics, debug hooks, sharded transfer paths)
        # index ANOTHER request's per-slot state.  The historical slot
        # stays available as done_slot.
        req.done_slot = req.slot
        req.slot = None

    def requeue(self, req: Request) -> None:
        """Preempt a slotted request back to QUEUED (slot freed, output and
        timing kept).

        The rid is unchanged, so the priority queue puts the request back
        at the head of its class — a preempted request is never overtaken
        by later arrivals of the same priority.  The engine is responsible
        for spilling/freeing the request's device state before calling
        this.
        """
        assert req.slot is not None, "only a slotted request can be requeued"
        assert req.state in (RequestState.PREFILL, RequestState.DECODE)
        self._slots[req.slot] = None
        req.slot = None
        req.state = RequestState.QUEUED
        req.preemptions += 1
        self._queue.append(req)

    def cancel(self, req: Request, reason: str, now: float = 0.0) -> None:
        """Kill a QUEUED request that never got (or no longer holds) a slot."""
        assert req.state is RequestState.QUEUED, req.state
        self._queue.remove(req)
        req.state = RequestState.DONE
        req.done_reason = reason
        req.done_time = now

    def expired(self, now: float) -> list[Request]:
        """Live requests whose deadline has passed, in rid order."""
        out = [
            r
            for r in self._requests.values()
            if r.state is not RequestState.DONE
            and r.deadline_ms is not None
            and (now - r.submit_time) * 1e3 > r.deadline_ms
        ]
        return sorted(out, key=lambda r: r.rid)

    # -- views --------------------------------------------------------------

    def active(self) -> list[Request]:
        """Requests currently decoding, in slot order."""
        return [
            r
            for r in self._slots
            if r is not None and r.state is RequestState.DECODE
        ]

    def occupancy(self) -> float:
        return sum(r is not None for r in self._slots) / self.n_slots

    def has_work(self) -> bool:
        return bool(self._queue) or any(
            r is not None for r in self._slots
        )

    def queued(self) -> int:
        return len(self._queue)

    def request(self, rid: int) -> Request:
        return self._requests[rid]

    def all_requests(self) -> list[Request]:
        """Every request ever submitted, in submission (rid) order."""
        return [self._requests[rid] for rid in sorted(self._requests)]
