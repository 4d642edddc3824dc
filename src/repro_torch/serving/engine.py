"""Batched inference engines: bucketed pad-aware prefill, chunked prefill
under a per-step token budget, and continuous-batch decode, over a dense
cache or a paged KV pool.

The torch twin of ``repro/serving/engine.py``'s ``_EngineBase``,
``InferenceEngine`` and ``PagedInferenceEngine`` (see that module's
docstring for the full contracts, which hold here unchanged):

* ``InferenceEngine`` (dense): every slot owns a ``max_len`` stripe of the
  stacked cache; a prefill writes in place into its slot's stripe;
* ``PagedInferenceEngine``: the KV cache is a shared pool of fixed-size
  pages (serving/paging.py); admission is gated on free pages, and page
  exhaustion preempts the newest sequence back to the waiting queue
  (recompute-style resume); prefill is truly paged: attention K/V scatter
  through the sequence's block-table row inside each layer; with
  ``chained_tables`` the decode resolves pages through two-level tables;
* ``cache_dtype`` picks the storage: f32, bf16, or int8 values with a bf16
  scale per (token, head);
* every prompt (and resume context) is right-padded to a power-of-two page
  bucket, so prefill runs at most ``num_buckets`` distinct shapes;
  ``compile_events`` counts the distinct prefill shapes executed and
  ``compile_ema_s`` times each first execution (on the card that includes
  building the kernel library, on the first shape);
* with ``chunk_tokens > 0`` admission only reserves capacity and a slot;
  each ``step()`` shares one token budget between the decode batch and
  prefill chunks (PREFILLING slots, FIFO, one chunk always);
* one reentrant ``lock`` covers every state-mutating entry point; the
  capacity probes are lock-free snapshots.

Where the JAX engines jit their steps and donate the cache buffers, these
run eagerly and update the preallocated caches in place. Options this port
does not have yet raise ``NotImplementedError`` naming their ROADMAP Queue 1
item: speculative decoding (``spec_tokens``) and the prefix cache at
construction, ``fork()`` when called.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import get_model
from repro_torch.models.common import dtype_name, resolve_device
from repro_torch.serving.paging import (
    NULL_PAGE,
    BlockAllocator,
    ChainedTables,
    PageTable,
    bucket_lengths,
    bucket_tokens,
    num_buckets,
)

_ROADMAP_ITEM = {"spec_tokens": 3, "prefix_cache": 4, "fork()": 5}


def _not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(f"{name} is not ported yet (ROADMAP Queue 1 item {_ROADMAP_ITEM[name]})")


def _apply_cache_dtype(cfg, choice: str):
    """Resolve the engine-level KV storage choice onto the model config:
    "" inherits, "f32"/"bf16" set the storage dtype, "int8" turns on KV
    quantization (values plus per-(token, head) scales)."""
    if not choice:
        return cfg
    if choice == "int8":
        return cfg.replace(kv_quant=True)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}.get(choice)
    if dt is None:
        raise ValueError(f"cache_dtype must be '', 'f32', 'bf16' or 'int8', got {choice!r}")
    return cfg.replace(kv_quant=False, kv_cache_dtype=dt)


def _kv_dtype_name(cfg) -> str:
    """The KV-cache storage dtype as telemetry sees it."""
    return "int8" if cfg.kv_quant else dtype_name(cfg.kv_dtype)


def _kv_bytes_per_token(cfg, cache, token_slots: int) -> float:
    """KV-cache bytes per cached-token slot across every attention layer,
    values plus scales for int8."""
    total = 0
    for i, kind in enumerate(cfg.block_pattern):
        if kind != "attn":
            continue
        for leaf in cache["blocks"][f"l{i}_mixer"].values():
            total += leaf.numel() * leaf.element_size()
    return total / max(1, token_slots)


@dataclass
class Sequence:
    sid: int
    prompt: List[int]
    out: List[int] = field(default_factory=list)
    done: bool = False
    preemptions: int = 0
    cached_tokens: int = 0      # prefix-cache hits: always 0 until it is ported
    submit_t: float = 0.0
    token_times: List[float] = field(default_factory=list)
    trace: Optional[object] = field(default=None, repr=False, compare=False)

    def context_tokens(self) -> List[int]:
        """Tokens that must be in cache to resume decoding (recompute)."""
        return list(self.prompt) + list(self.out)

    @property
    def lane(self) -> str:
        """Trace lane for this sequence's engine-side spans."""
        return f"engine-sid{self.sid}"


def _sync(t: torch.Tensor) -> None:
    """Wait for the device work behind ``t`` (timing a first execution)."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


class _EngineBase:
    """Shared continuous-batching scaffolding: submission, stop conditions,
    prefill bucketing with its compile-event accounting, pre-warming, the
    chunked-prefill (PREFILLING) state machine with its per-step token
    budget, and the synchronous generate loop."""

    def free_slots(self) -> int:
        return sum(1 for s in self.slot_seq if s is None)

    def submit(self, prompt: List[int], trace=None) -> int:
        with self.lock:
            seq = Sequence(self._sid, list(prompt), submit_t=time.monotonic(), trace=trace)
            self._sid += 1
            self.waiting.append(seq)
            if trace is not None:
                trace.event("engine_submit", lane=seq.lane, t=seq.submit_t,
                            sid=seq.sid, prompt_tokens=len(prompt))
            return seq.sid

    # -- bucketed prefill shapes ---------------------------------------------
    def _bucket_len(self, n: int, cap: int = 0) -> int:
        if not self._bucket_on:
            return n
        return bucket_tokens(n, self._bucket_unit, cap or self._len_cap)

    def _pad_context(self, ctx_toks: List[int], cap: int = 0):
        """Right-pad a context to its bucket; returns (tokens, n_valid, Lp,
        fresh) where ``fresh`` marks a shape not executed before."""
        n = len(ctx_toks)
        Lp = self._bucket_len(n, cap)
        fresh = Lp not in self._prefill_shapes
        self._prefill_shapes.add(Lp)
        toks = np.zeros(Lp, np.int64)
        toks[:n] = ctx_toks
        return toks, n, Lp, fresh

    def _note_compile(self, dt_s: float) -> None:
        prev = self._compile_ema_s
        self._compile_ema_s = dt_s if prev is None else 0.5 * prev + 0.5 * dt_s

    @property
    def compile_ema_s(self) -> float:
        """EMA of first-execution wall time per prefill shape; 0.0 until one
        is measured."""
        return self._compile_ema_s or 0.0

    @property
    def compile_events(self) -> int:
        """Distinct prefill shapes executed so far."""
        return len(self._prefill_shapes)

    @property
    def _shape_cap(self) -> int:
        return self._chunk_tokens or self._len_cap

    @property
    def total_buckets(self) -> int:
        return num_buckets(self._bucket_unit, self._shape_cap) if self._bucket_on else 0

    @property
    def step_budget(self) -> int:
        if self._step_budget:
            return self._step_budget
        return 2 * self._chunk_tokens if self._chunk_tokens else self._len_cap

    # -- chunked prefill state machine -----------------------------------------
    def _resolve_chunking(self, chunk_tokens: int, unit: int, cap: int,
                          require_divisible: bool) -> int:
        """Snap the chunk size to a positive multiple of the bucket unit,
        capped at the length cap. The dense engine requires the cap to be a
        chunk multiple (its stripe writes would otherwise clamp at the
        edge); the paged engine's tail overruns land on the null page."""
        if not chunk_tokens:
            return 0
        ct = min(-(-chunk_tokens // unit) * unit, cap)
        if require_divisible and cap % ct != 0:
            raise ValueError(f"chunk_tokens={ct} must divide the length cap {cap} "
                             "(dense stripe writes cannot overrun the cache edge)")
        return ct

    def _init_chunk_slots(self, B: int) -> None:
        self._chunking = [False] * B
        self._chunk_pos = np.zeros(B, np.int32)
        self._chunk_ctx = [None] * B
        self._chunk_carry = [None] * B

    def _clear_chunk_slot(self, slot: int) -> None:
        self._chunking[slot] = False
        self._chunk_pos[slot] = 0
        self._chunk_ctx[slot] = None
        self._chunk_carry[slot] = None

    def _begin_chunked(self, slot: int, seq: Sequence, start: int = 0) -> None:
        """Move ``seq`` into ``slot`` in the PREFILLING state; the chunk
        phase absorbs its context over the following steps."""
        self.slot_seq[slot] = seq
        self.slot_len[slot] = start
        self._chunking[slot] = True
        self._chunk_pos[slot] = start
        self._chunk_ctx[slot] = seq.context_tokens()
        self._chunk_carry[slot] = self.model.init_chunk_state(self.device)
        self._stamp[slot] = self._stamp_next
        self._stamp_next += 1
        if seq.trace is not None:
            seq.trace.event(
                "admitted", lane=seq.lane, slot=slot, chunked=True,
                ctx_tokens=len(self._chunk_ctx[slot]), resume=seq.preemptions,
                cached_tokens=start,
            )

    def _prefilling_slots(self) -> List[int]:
        return sorted(
            (i for i in range(len(self.slot_seq)) if self._chunking[i]),
            key=lambda i: self._stamp[i],
        )

    @property
    def _chunk_unit(self) -> int:
        return self._chunk_tokens or self._len_cap

    def _next_chunk_cost(self, slot: int) -> int:
        remaining = len(self._chunk_ctx[slot]) - int(self._chunk_pos[slot])
        return self._bucket_len(min(remaining, self._chunk_unit), self._chunk_unit)

    def _run_chunks(self, spent: int, budget: int) -> int:
        """Serve PREFILLING slots in admission order within the budget, but
        always at least one chunk when any slot is mid-prefill."""
        first = True
        for slot in self._prefilling_slots():
            while self._chunking[slot]:
                cost = self._next_chunk_cost(slot)
                if not first and spent + cost > budget:
                    return spent
                spent += cost
                self._chunk_step(slot)
                first = False
        return spent

    def _chunk_step(self, slot: int) -> None:
        """Run ONE prefill chunk; the final chunk emits the prefill token and
        flips the slot to decoding under the usual stop conditions."""
        seq = self.slot_seq[slot]
        ctx = self._chunk_ctx[slot]
        pos = int(self._chunk_pos[slot])
        piece = ctx[pos : pos + self._chunk_unit]
        toks, n, _, fresh = self._pad_context(piece, cap=self._chunk_unit)
        tr = seq.trace
        tr0 = time.monotonic() if tr is not None else 0.0
        t0 = time.perf_counter()
        nxt = self._run_chunk_device(slot, toks, pos, n)
        if fresh:
            _sync(nxt)
            self._note_compile(time.perf_counter() - t0)
        if tr is not None:
            tr.add_span("prefill_chunk", tr0, time.monotonic(), lane=seq.lane,
                        offset=pos, tokens=n, fresh_compile=fresh)
        new_pos = pos + n
        self._chunk_pos[slot] = new_pos
        self.slot_len[slot] = new_pos
        if new_pos < len(ctx):
            return                                    # mid-prefill: token is garbage
        self.cache = self.model.install_chunk_state(self.cache, self._chunk_carry[slot], slot)
        self._clear_chunk_slot(slot)              # PREFILLING -> decoding
        tok = int(nxt)
        self._last[slot] = tok
        seq.out.append(tok)
        seq.token_times.append(time.monotonic())
        self.tokens_emitted += 1
        if self._stop_hit(seq, tok, int(self.slot_len[slot])):
            seq.done = True
            self._just_finished.append(seq)
            self._release_slot(slot)

    def prefill_backlog_tokens(self) -> int:
        """Prompt tokens not yet absorbed (lock-free, possibly stale)."""
        backlog = 0
        for i in range(len(self.slot_seq)):
            ctx = self._chunk_ctx[i]
            if ctx is None:
                continue
            backlog += max(0, len(ctx) - int(self._chunk_pos[i]))
        try:
            backlog += sum(len(s.prompt) + len(s.out) for s in list(self.waiting))
        except RuntimeError:
            pass          # deque mutated mid-iteration: skip the stale part
        return backlog

    def prewarm(self, buckets: Optional[List[int]] = None) -> List[int]:
        """Run the prefill path once per bucket length (default: every
        bucket) through an idle slot before traffic arrives. On the card the
        first run also builds the kernel library, so call this on the main
        thread before any loop or router thread starts. Each shape counts
        toward ``compile_events``. Returns the lengths warmed."""
        with self.lock:
            if buckets is None:
                if not self._bucket_on:
                    return []
                buckets = bucket_lengths(self._bucket_unit, self._shape_cap)
            warmed: List[int] = []
            for Lp in sorted({int(b) for b in buckets}):
                Lp = self._bucket_len(max(1, Lp), self._shape_cap)
                if Lp in self._prefill_shapes:
                    continue
                slot = next((i for i, s in enumerate(self.slot_seq) if s is None), None)
                if slot is None:
                    break
                t0 = time.perf_counter()
                self._prewarm_shape(Lp, slot)
                self._note_compile(time.perf_counter() - t0)
                self._prefill_shapes.add(Lp)
                warmed.append(Lp)
            return warmed

    def _stop_hit(self, seq: Sequence, tok: int, cache_len: int) -> bool:
        return (
            len(seq.out) >= self._max_new
            or tok == self._eos
            or cache_len >= self._len_cap - 1
        )

    def _init_spec(self) -> None:
        """Throughput accounting read by ``capacity_now()`` and EngineLoop
        (speculation itself is not ported: its counters stay 0)."""
        self.tokens_emitted = 0
        self.spec_runs: List[int] = []
        self.spec_proposed = 0
        self.spec_accepted = 0

    def generate(self, prompts: List[List[int]], max_steps: int = 10000) -> List[Sequence]:
        """Synchronous convenience: runs until all prompts finish while
        holding the engine lock (the serving path is EngineLoop)."""
        with self.lock:
            done: List[Sequence] = []
            for p in prompts:
                self.submit(p)
            for _ in range(max_steps):
                done.extend(self.step())
                if not self.waiting and all(s is None for s in self.slot_seq):
                    break
            return sorted(done, key=lambda s: s.sid)


@dataclass
class EngineConfig:
    max_slots: int = 4
    max_len: int = 256
    max_new_tokens: int = 32
    eos_id: int = -1            # -1: never stop early
    bucket_unit: int = 16       # prefill pad quantum (the dense "page unit")
    bucket_prefill: bool = True # False: one prefill shape per distinct length
    chunk_tokens: int = 0       # >0: chunked prefill, tokens per chunk (snapped
                                # to a bucket_unit multiple; must divide max_len)
    step_token_budget: int = 0  # 0 = auto: 2*chunk_tokens chunked, max_len not
    spec_tokens: int = 0        # not ported yet
    spec_ngram: int = 3
    cache_dtype: str = ""       # "" inherit | "f32" | "bf16" | "int8"


class InferenceEngine(_EngineBase):
    """Continuous batching over a dense cache: ``max_slots`` stripes of
    ``max_len`` positions, one per slot, reserved whole at admission.

    ``params`` is the port's parameter tree (on ``device``); without it the
    weights are drawn from ``torch.Generator(device).manual_seed(seed)``.
    ``device=None`` means the card; pass ``device="cpu"`` to run the plain
    versions of the kernels on the CPU. A prefill writes in place into its
    slot's stripe of the stacked cache (the JAX engine builds a one-slot
    cache and writes it back): recurrent mixers start from zero state, as in
    the JAX engine's fresh cache, and attention positions past the prompt
    keep what an earlier occupant left there, which the length masks
    hide."""

    def __init__(self, cfg, ecfg: EngineConfig, params=None, seed: int = 0, device=None):
        if ecfg.spec_tokens:
            raise _not_ported("spec_tokens")
        cfg = _apply_cache_dtype(cfg, ecfg.cache_dtype)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = ecfg
        self.model = get_model(cfg)
        if params is None:
            params = self.model.init(torch.Generator(self.device).manual_seed(seed))
        self.params = params
        self._max_new, self._eos, self._len_cap = ecfg.max_new_tokens, ecfg.eos_id, ecfg.max_len
        self._bucket_unit, self._bucket_on = ecfg.bucket_unit, ecfg.bucket_prefill
        self._chunk_tokens = self._resolve_chunking(ecfg.chunk_tokens, ecfg.bucket_unit,
                                                    ecfg.max_len, require_divisible=True)
        self._spec_tokens = 0
        self._init_spec()
        self._step_budget = ecfg.step_token_budget
        self._prefill_shapes = set()
        self._compile_ema_s: Optional[float] = None
        self.lock = threading.RLock()  # locklint: blocking-ok one stepper owns the cache
        B, L = ecfg.max_slots, ecfg.max_len
        self.cache = self.model.init_cache(B, L, self.device)
        self._kv_bytes_per_token = _kv_bytes_per_token(cfg, self.cache, B * L)
        self.slot_len = np.zeros(B, np.int32)        # tokens in cache per slot
        self.slot_seq: List[Optional[Sequence]] = [None] * B
        self.waiting: Deque[Sequence] = deque()
        self._sid = 0
        self._just_finished: List[Sequence] = []
        self._init_chunk_slots(B)
        self._stamp = np.zeros(B, np.int64)   # admission order (chunk FIFO)
        self._stamp_next = 1
        self._last = np.zeros(B, np.int64)

    # -- device steps -----------------------------------------------------------
    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def _slot_view(self, slot: int) -> dict:
        """One slot's stripe of every cache leaf, as a B = 1 cache of views:
        writes through it land in the stacked cache."""
        return {"blocks": {key: {name: leaf[:, slot:slot + 1] for name, leaf in leaves.items()}
                           for key, leaves in self.cache["blocks"].items()}}

    def _prefill(self, toks, slot: int, n_valid: int) -> torch.Tensor:
        """Prefill one bucket-padded prompt into ``slot``'s stripe from
        position 0. Returns the next token (0-dim)."""
        batch = {"tokens": self._tensor(toks, torch.long)[None, :], "n_valid": n_valid}
        nxt, _ = self.model.prefill(self.params, batch, self._slot_view(slot))
        return nxt[0]

    def _run_chunk_device(self, slot: int, toks, offset: int, n: int) -> torch.Tensor:
        batch = {"tokens": self._tensor(toks, torch.long)[None, :], "n_valid": n, "offset": offset}
        nxt, _, self._chunk_carry[slot] = self.model.prefill_chunk(
            self.params, batch, self._slot_view(slot), self._chunk_carry[slot])
        return nxt[0]

    def _decode(self) -> np.ndarray:
        """One decode step for every slot; per-slot lengths drive the cache
        writes, the masks and the positions (dead slots write at 0)."""
        batch = {"token": self._tensor(self._last, torch.long)[:, None],
                 "lengths": self._tensor(self.slot_len)}
        nxt, self.cache = self.model.decode(self.params, self.cache, batch)
        return nxt.cpu().numpy()

    # -- capacity telemetry ------------------------------------------------------
    def capacity_now(self) -> Dict[str, int]:
        """Live capacity snapshot for the placer; the dense engine reserves
        max_len cache tokens per admitted slot."""
        free = self.free_slots()
        return {
            "free_slots": free,
            "num_slots": self.ecfg.max_slots,
            "free_cache_tokens": free * self.ecfg.max_len,
            "cache_tokens": self.ecfg.max_slots * self.ecfg.max_len,
            "kv_cache_dtype": _kv_dtype_name(self.cfg),
            "kv_bytes_per_token": self._kv_bytes_per_token,
            "waiting": len(self.waiting),
            "compile_events": self.compile_events,
            "total_buckets": self.total_buckets,
            "compile_ema_s": self.compile_ema_s,
            "prefilling_slots": sum(self._chunking),
            "prefill_backlog_tokens": self.prefill_backlog_tokens(),
            "chunk_tokens": self._chunk_tokens,
            "spec_tokens": self._spec_tokens,
            "tokens_emitted": self.tokens_emitted,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
        }

    def admission_capacity(self, est_tokens: int = 0) -> int:
        """How many more requests this engine can admit right now."""
        return self.free_slots()

    # -- public API -------------------------------------------------------------
    def _prewarm_shape(self, Lp: int, slot: int) -> None:
        """Run a prefill at shape ``Lp`` into a free slot's stripe (the
        chunk path when chunking is on). The stray writes are harmless: the
        slot's next occupant overwrites positions from 0, the length masks
        hide the rest, and its prefill zeroes (or its last chunk installs)
        the recurrent state."""
        toks = np.zeros(Lp, np.int64)
        if self._chunk_tokens:
            batch = {"tokens": self._tensor(toks, torch.long)[None, :], "n_valid": 1, "offset": 0}
            nxt, _, _ = self.model.prefill_chunk(self.params, batch, self._slot_view(slot),
                                                 self.model.init_chunk_state(self.device))
        else:
            nxt = self._prefill(toks, slot, 1)
        _sync(nxt)

    def _release_slot(self, slot: int) -> None:
        self.slot_seq[slot] = None
        self.slot_len[slot] = 0
        self._clear_chunk_slot(slot)
        self._stamp[slot] = 0

    def _admit(self, spent: int = 0, budget: int = 0) -> int:
        """Budget-gated admission. Chunked: free slots become PREFILLING at
        no device cost. Unchunked: the first prefill of a step is always
        admitted, every further one must fit ``budget``. Returns the updated
        spend."""
        budget = budget or self.step_budget
        admitted = False
        for i in range(self.ecfg.max_slots):
            if self.slot_seq[i] is not None or not self.waiting:
                continue
            if self._chunk_tokens:
                self._begin_chunked(i, self.waiting.popleft())
                continue
            Lp = self._bucket_len(len(self.waiting[0].prompt))
            if admitted and spent + Lp > budget:
                break                        # over budget: stays queued
            seq = self.waiting.popleft()
            toks, n, _, fresh = self._pad_context(seq.prompt)
            tr = seq.trace
            tr0 = time.monotonic() if tr is not None else 0.0
            t0 = time.perf_counter()
            nxt = int(self._prefill(toks, i, n))
            if fresh:
                self._note_compile(time.perf_counter() - t0)
            if tr is not None:
                tr.add_span("prefill", tr0, time.monotonic(), lane=seq.lane,
                            slot=i, tokens=n, fresh_compile=fresh)
            spent += Lp
            admitted = True
            self.slot_seq[i] = seq
            self.slot_len[i] = n
            self._last[i] = nxt
            seq.out.append(nxt)
            seq.token_times.append(time.monotonic())
            self.tokens_emitted += 1
            if self._stop_hit(seq, nxt, int(self.slot_len[i])):
                seq.done = True
                self._just_finished.append(seq)
                self._release_slot(i)
        return spent

    def step(self) -> List[Sequence]:
        """Admit (budget-gated) + chunk work + one decode step; returns the
        sequences finished. The batched decode sweeps every slot: PREFILLING
        slots' writes land on the chunk cursor (rewritten by the next chunk),
        idle slots' at position 0 of their stripe."""
        with self.lock:
            budget = self.step_budget
            self.spec_runs = []
            spent = sum(
                1 for i, s in enumerate(self.slot_seq)
                if s is not None and not self._chunking[i]
            )
            spent = self._admit(spent, budget)
            if self._chunk_tokens:
                spent = self._run_chunks(spent, budget)
            active = [
                i for i in range(self.ecfg.max_slots)
                if self.slot_seq[i] is not None and not self._chunking[i]
            ]
            finished, self._just_finished = self._just_finished, []
            if active:
                nxt = self._decode()
                tok_t = time.monotonic()      # one stamp per batched decode step
                for i in active:
                    seq = self.slot_seq[i]
                    self.slot_len[i] += 1
                    self._last[i] = nxt[i]
                    seq.out.append(int(nxt[i]))
                    seq.token_times.append(tok_t)
                    self.tokens_emitted += 1
                    if self._stop_hit(seq, int(nxt[i]), int(self.slot_len[i])):
                        seq.done = True
                        finished.append(seq)
                        self._release_slot(i)
            return finished


@dataclass
class PagedEngineConfig:
    page_size: int = 16
    num_pages: int = 64          # pool size, incl. the reserved null page 0
    max_slots: int = 8           # decode batch width
    max_seq_len: int = 256       # block-table width = ceil(max_seq_len / page_size)
    max_new_tokens: int = 32
    eos_id: int = -1
    bucket_prefill: bool = True  # pad prefill to power-of-two page buckets
    chunk_tokens: int = 0        # >0: chunked prefill, tokens per chunk
    step_token_budget: int = 0   # 0 = auto: 2*chunk_tokens chunked, cap not
    prefix_cache: bool = False   # not ported yet
    spec_tokens: int = 0         # not ported yet
    cache_dtype: str = ""        # "" inherit | "f32" | "bf16" | "int8"
    chained_tables: bool = False # two-level block tables: lifts num_pages >= table_width
    table_page_entries: int = 0  # chained: physical pages per second-level row (0 = page_size)

    @property
    def table_width(self) -> int:
        return -(-self.max_seq_len // self.page_size)

    @property
    def cache_tokens(self) -> int:
        """Usable cache budget in tokens (null page excluded)."""
        return (self.num_pages - 1) * self.page_size


class PagedInferenceEngine(_EngineBase):
    """Continuous batching over a paged KV cache on one device.

    ``params`` is the port's parameter tree (on ``device``); without it the
    weights are drawn from ``torch.Generator(device).manual_seed(seed)``.
    ``device=None`` means the card; pass ``device="cpu"`` to run the plain
    versions of the kernels on the CPU."""

    def __init__(self, cfg, pcfg: PagedEngineConfig, params=None, seed: int = 0, device=None):
        for name, on in (("spec_tokens", pcfg.spec_tokens), ("prefix_cache", pcfg.prefix_cache)):
            if on:
                raise _not_ported(name)
        cfg = _apply_cache_dtype(cfg, pcfg.cache_dtype)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.pcfg = pcfg
        if not pcfg.chained_tables and pcfg.num_pages - 1 < pcfg.table_width:
            # chained tables drop this coupling: their length cap is what
            # the pool can hold (see _len_cap below)
            raise ValueError(
                f"num_pages={pcfg.num_pages} cannot hold one max_seq_len={pcfg.max_seq_len} "
                f"sequence ({pcfg.table_width} pages + reserved null page)"
            )
        self.model = get_model(cfg)
        if params is None:
            params = self.model.init(torch.Generator(self.device).manual_seed(seed))
        self.params = params
        self._max_new, self._eos = pcfg.max_new_tokens, pcfg.eos_id
        self._len_cap = (min(pcfg.max_seq_len, pcfg.cache_tokens) if pcfg.chained_tables
                         else pcfg.max_seq_len)
        self._bucket_unit, self._bucket_on = pcfg.page_size, pcfg.bucket_prefill
        self._chunk_tokens = self._resolve_chunking(pcfg.chunk_tokens, pcfg.page_size,
                                                    self._len_cap, require_divisible=False)
        self._spec_tokens = 0
        self._init_spec()
        self._step_budget = pcfg.step_token_budget
        self._prefill_shapes = set()
        self._compile_ema_s: Optional[float] = None
        self.lock = threading.RLock()  # locklint: blocking-ok one stepper owns the pools
        B = pcfg.max_slots
        if pcfg.chained_tables:
            # a sequence holds at most min(table_width, num_pages - 1) data
            # pages: the flat row a chain encodes is that many entries
            # rounded up to whole table pages. The flat block_tab is still
            # kept for the write side; only the batched decode walks the chain.
            tpp = pcfg.table_page_entries or pcfg.page_size
            max_pages = min(pcfg.table_width, pcfg.num_pages - 1)
            self.chain: Optional[ChainedTables] = ChainedTables(B, -(-max_pages // tpp), tpp)
            self._row_width = self.chain.width1 * tpp
        else:
            self.chain = None
            self._row_width = pcfg.table_width
        self.cache = self.model.init_paged_cache(pcfg.num_pages, pcfg.page_size, self.device, B)
        self._kv_bytes_per_token = _kv_bytes_per_token(
            cfg, self.cache, pcfg.num_pages * pcfg.page_size
        )
        self.allocator = BlockAllocator(pcfg.num_pages, pcfg.page_size)
        self.prefix_cache = None
        self.tables: List[Optional[PageTable]] = [None] * B
        self.slot_len = np.zeros(B, np.int32)
        self.slot_seq: List[Optional[Sequence]] = [None] * B
        self.block_tab = np.full((B, self._row_width), NULL_PAGE, np.int32)
        self.waiting: Deque[Sequence] = deque()
        self.preemptions = 0
        self.peak_active = 0
        self._sid = 0
        self._stamp = np.zeros(B, np.int64)   # admission order, newest = max
        self._stamp_next = 1
        self._just_finished: List[Sequence] = []
        self._last = np.zeros(B, np.int64)
        self._init_chunk_slots(B)

    # -- device steps -----------------------------------------------------------
    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def _prefill(self, toks, tab_row, slot: int, n_valid: int) -> torch.Tensor:
        """Prefill one bucket-padded sequence through the model's paged path
        (pads land on the null page). Returns the next token (0-dim)."""
        batch = {"tokens": self._tensor(toks, torch.long)[None, :], "n_valid": n_valid,
                 "tab_row": self._tensor(tab_row), "slot": slot}
        nxt, self.cache = self.model.prefill_paged(self.params, batch, self.cache)
        return nxt[0]

    def _run_chunk_device(self, slot: int, toks, offset: int, n: int) -> torch.Tensor:
        batch = {"tokens": self._tensor(toks, torch.long)[None, :], "n_valid": n,
                 "tab_row": self._tensor(self.block_tab[slot]), "slot": slot, "offset": offset}
        nxt, self.cache, self._chunk_carry[slot] = self.model.prefill_chunk_paged(
            self.params, batch, self.cache, self._chunk_carry[slot])
        return nxt[0]

    def _decode(self) -> np.ndarray:
        batch = {"token": self._tensor(self._last, torch.long)[:, None],
                 "lengths": self._tensor(self.slot_len)}
        if self.chain is not None:
            batch["block_tab"] = self._tensor(self.chain.l1)
            batch["l2_tab"] = self._tensor(self.chain.l2)
        else:
            batch["block_tab"] = self._tensor(self.block_tab)
        nxt, self.cache = self.model.decode(self.params, self.cache, batch)
        return nxt.cpu().numpy()

    # -- capacity telemetry ------------------------------------------------------
    def free_pages(self) -> int:
        return self.allocator.free_pages

    def capacity_now(self) -> Dict[str, int]:
        """Live capacity snapshot, the keys the StraightLine placer reads."""
        return {
            "free_slots": self.free_slots(),
            "num_slots": self.pcfg.max_slots,
            "free_pages": self.allocator.free_pages,
            "num_pages": self.pcfg.num_pages - 1,
            "free_cache_tokens": self.allocator.free_pages * self.pcfg.page_size,
            "cache_tokens": self.pcfg.cache_tokens,
            "kv_cache_dtype": _kv_dtype_name(self.cfg),
            "kv_bytes_per_token": self._kv_bytes_per_token,
            "waiting": len(self.waiting),
            "compile_events": self.compile_events,
            "total_buckets": self.total_buckets,
            "compile_ema_s": self.compile_ema_s,
            "prefilling_slots": sum(self._chunking),
            "prefill_backlog_tokens": self.prefill_backlog_tokens(),
            "chunk_tokens": self._chunk_tokens,
            "spec_tokens": self._spec_tokens,
            "tokens_emitted": self.tokens_emitted,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
        }

    def admission_capacity(self, est_tokens: int = 0) -> int:
        """How many requests of ~est_tokens context the engine can admit now
        (page- and slot-bounded)."""
        est = max(1, est_tokens)
        per_seq = PageTable.pages_needed(est + 1, self.pcfg.page_size)
        return min(self.free_slots(), self.allocator.free_pages // per_seq)

    # -- public API -------------------------------------------------------------
    def _prewarm_shape(self, Lp: int, slot: int) -> None:
        """Run a prefill at shape ``Lp`` through an all-null block-table row
        (writes land on the null page); the chunk path when chunking is on."""
        toks = np.zeros(Lp, np.int64)
        row = np.full(self._row_width, NULL_PAGE, np.int32)
        if self._chunk_tokens:
            batch = {"tokens": self._tensor(toks, torch.long)[None, :], "n_valid": 1,
                     "tab_row": self._tensor(row), "slot": slot, "offset": 0}
            nxt, self.cache, _ = self.model.prefill_chunk_paged(
                self.params, batch, self.cache, self.model.init_chunk_state(self.device))
        else:
            nxt = self._prefill(toks, row, slot, 1)
        _sync(nxt)

    def submit(self, prompt: List[int], trace=None) -> int:
        if len(prompt) + self.pcfg.max_new_tokens > self._len_cap:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens exceeds the length "
                f"cap {self._len_cap} (max_seq_len={self.pcfg.max_seq_len}, "
                f"pool={self.pcfg.cache_tokens} tokens)"
            )
        return super().submit(prompt, trace=trace)

    def _free_slot(self) -> Optional[int]:
        for i in range(self.pcfg.max_slots):
            if self.slot_seq[i] is None:
                return i
        return None

    def _sync_row(self, slot: int) -> None:
        """Single owner of the host block-table views after any page-list
        change: rewrites the slot's flat row and, with chained tables, its
        first- and second-level entries, so the two views never disagree."""
        table = self.tables[slot]
        pages = table.pages if table is not None else []
        self.block_tab[slot, :] = table.row(self._row_width) if pages else NULL_PAGE
        if self.chain is not None:
            self.chain.set_row(slot, pages)

    def _install(self, slot: int, seq: Sequence, table: PageTable) -> int:
        """Prefill seq's full context (bucket-padded) through ``table`` into
        slot; returns the emitted next token."""
        ctx_toks = seq.context_tokens()
        table.num_tokens = len(ctx_toks)
        self.tables[slot] = table
        self._sync_row(slot)
        toks, n, _, fresh = self._pad_context(ctx_toks)
        tr = seq.trace
        tr0 = time.monotonic() if tr is not None else 0.0
        t0 = time.perf_counter()
        nxt = int(self._prefill(toks, self.block_tab[slot], slot, n))
        if fresh:
            self._note_compile(time.perf_counter() - t0)
        if tr is not None:
            tr.add_span("prefill", tr0, time.monotonic(), lane=seq.lane,
                        slot=slot, tokens=n, fresh_compile=fresh,
                        resume=seq.preemptions)
        self.slot_seq[slot] = seq
        self.slot_len[slot] = n
        self._last[slot] = nxt
        self._stamp[slot] = self._stamp_next
        self._stamp_next += 1
        return nxt

    def _release(self, slot: int) -> None:
        """Tear down a slot and free its pages."""
        self.tables[slot].release(self.allocator)
        self.tables[slot] = None
        self.slot_seq[slot] = None
        self.slot_len[slot] = 0
        self._sync_row(slot)
        self._stamp[slot] = 0
        # a preempted PREFILLING slot drops its chunk progress: re-admission
        # restarts the chunked prefill from scratch
        self._clear_chunk_slot(slot)

    _release_slot = _release          # shared _chunk_step hook (see _EngineBase)

    def _admit(self, spent: int = 0, budget: int = 0) -> int:
        """Budget-gated page-gated admission. Chunked: the full context's
        pages are reserved up front and the slot enters PREFILLING. Returns
        the updated spend."""
        budget = budget or self.step_budget
        admitted = False
        while self.waiting:
            slot = self._free_slot()
            if slot is None:
                break
            seq = self.waiting[0]
            ctx_len = len(seq.prompt) + len(seq.out)
            need = PageTable.pages_needed(ctx_len + 1, self.pcfg.page_size)
            if not self.allocator.can_alloc(need):
                break                                    # page-gated admission
            if self._chunk_tokens:
                self.waiting.popleft()
                table = PageTable(self.pcfg.page_size, self.allocator.alloc(need))
                table.num_tokens = ctx_len
                self.tables[slot] = table
                self._sync_row(slot)
                self._begin_chunked(slot, seq)
                continue
            Lp = self._bucket_len(ctx_len)
            if admitted and spent + Lp > budget:
                break                                    # over budget: stays queued
            self.waiting.popleft()
            table = PageTable(self.pcfg.page_size, self.allocator.alloc(need))
            nxt = self._install(slot, seq, table)
            spent += Lp
            admitted = True
            seq.out.append(nxt)
            seq.token_times.append(time.monotonic())
            self.tokens_emitted += 1
            if self._stop_hit(seq, nxt, int(self.slot_len[slot])):
                seq.done = True
                self._just_finished.append(seq)
                self._release(slot)
        return spent

    def _preempt_newest(self, active: List[int]) -> int:
        """Evict the most recently admitted active sequence back to the
        waiting queue (front), releasing its pages. Returns the slot."""
        victim = max(active, key=lambda i: self._stamp[i])
        seq = self.slot_seq[victim]
        seq.preemptions += 1
        self.preemptions += 1
        if seq.trace is not None:
            seq.trace.event("preempted", lane=seq.lane, slot=victim,
                            n_out=len(seq.out), preemptions=seq.preemptions)
        self.waiting.appendleft(seq)
        self._release(victim)
        active.remove(victim)
        return victim

    def _ensure_growth(self, active: List[int]) -> None:
        """Every active slot writes one token at position slot_len this step;
        allocate the page that position lands in, preempting the newest
        sequence when the pool is dry."""
        for slot in sorted(active, key=lambda i: self._stamp[i]):
            if slot not in active:
                continue
            while self.tables[slot].capacity_tokens <= self.slot_len[slot]:
                if not self.allocator.can_alloc(1):
                    if active == [slot]:
                        raise RuntimeError(
                            "page pool too small to grow the only active sequence; "
                            "increase num_pages"
                        )
                    preempted = self._preempt_newest(active)
                    if preempted == slot:
                        break
                    continue
                self.tables[slot].append_pages(self.allocator.alloc(1))
                self._sync_row(slot)

    def step(self) -> List[Sequence]:
        """Grow + admit (budget-gated) + chunk work + one batched decode
        step; returns the sequences finished. The batched decode sweeps every
        slot: PREFILLING slots' writes land on the chunk cursor's allocated
        page (rewritten by the next chunk), idle slots' on the null page."""
        with self.lock:
            budget = self.step_budget
            self.spec_runs = []
            occupied = [i for i in range(self.pcfg.max_slots) if self.slot_seq[i] is not None]
            self._ensure_growth(occupied)
            spent = sum(
                1 for i, s in enumerate(self.slot_seq)
                if s is not None and not self._chunking[i]
            )
            spent = self._admit(spent, budget)
            if self._chunk_tokens:
                spent = self._run_chunks(spent, budget)
            active = [
                i for i in range(self.pcfg.max_slots)
                if self.slot_seq[i] is not None and not self._chunking[i]
            ]
            self.peak_active = max(self.peak_active, len(active))
            finished, self._just_finished = self._just_finished, []
            if active:
                nxt = self._decode()
                tok_t = time.monotonic()      # one stamp per batched decode step
                for i in active:
                    seq = self.slot_seq[i]
                    self.slot_len[i] += 1
                    self.tables[i].num_tokens = int(self.slot_len[i])
                    self._last[i] = nxt[i]
                    seq.out.append(int(nxt[i]))
                    seq.token_times.append(tok_t)
                    self.tokens_emitted += 1
                    if self._stop_hit(seq, int(nxt[i]), int(self.slot_len[i])):
                        seq.done = True
                        finished.append(seq)
                        self._release(i)
            return finished

    def fork(self, sid: int) -> Optional[int]:
        raise _not_ported("fork()")
