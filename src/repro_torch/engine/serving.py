"""Memory-planned serving engine: continuous batching with KV-cache
admission.

The training planner sizes micro-batches against an activation memory
model; serving is the same admission problem with a different cost per
unit: a decoding request holds a KV-cache slot
(``memory_model.kv_slot_bytes``), so :func:`plan_serve` bounds the number
of concurrently decoding requests and the prefill micro-batch against the
memory budget as ``plan_mbs`` bounds the micro-batch. The arithmetic is
the JAX package's, so both admit the same plans.

Request lifecycle:

    QUEUED --admit (free slot + prefill micro-batch)--> PREFILL
    PREFILL --first token sampled, cache row copied in--> DECODE
    DECODE --max_new_tokens reached--> FINISHED (slot evicted, reusable)

Continuous batching: every decode step runs ``transformer.decode_step``
over the whole fixed-shape slot pool (``kv.KVPool``); inactive slots
compute garbage that the host drops. The step's tokens and positions live
on the device and the step reads one thing back, the next tokens. Prefill
is micro-batched: pure-attention stacks take right-padded ragged groups
(``transformer.prefill(lengths=...)``, exact because causal attention
never lets a real query see the padding), while the state-carrying (ssm,
recurrent) and MoE families group prompts of one exact length, since
padding would run through their scans or compete for expert capacity
(``transformer.supports_ragged_prefill``). Encoder-decoder configs are
refused up front.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .. import tree
from ..core import memory_model
from ..models import transformer
from ..models.config import ModelConfig
from .kv import KVPool

# request lifecycle states
QUEUED = "queued"
PREFILL = "prefill"
DECODE = "decode"
FINISHED = "finished"


_ENCDEC_NOTE = ("encoder-decoder configs are not servable by the "
                "decoder-only serving engine (no cross-attention cache in "
                "init_cache/decode_step); serve a decoder-only arch instead")


def check_servable(cfg: ModelConfig) -> None:
    """Fail fast, before any tensor is allocated, with the JAX package's
    messages: an enc-dec config (``models.encdec`` decodes one batch
    through its own cross-attention cache, but this engine's pool is the
    decoder-only ``init_cache``), and a layer kind without a decode-cache
    slot. A VLM serves text-only, as in the JAX package."""
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name}: {_ENCDEC_NOTE}")
    for kind in cfg.layer_pattern:
        if kind not in ("global", "local", "ssm", "recurrent"):
            raise ValueError(
                f"{cfg.name}: layer kind {kind!r} has no decode-cache slot "
                "in transformer.init_cache — cannot serve this pattern")


@dataclasses.dataclass
class Request:
    """One generation request moving through the lifecycle."""
    rid: int
    prompt: np.ndarray  # (L,) int32 token ids
    max_new_tokens: int
    arrival_s: float = 0.0  # offset from stream start

    # filled in by the engine
    state: str = QUEUED
    slot: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    queued_s: Optional[float] = None
    first_token_s: Optional[float] = None  # TTFT = first_token_s - arrival_s
    finish_s: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """Admission geometry of one serving setup — the serving sibling of
    :class:`engine.plan.MBSPlan`.

    ``max_decode_slots`` bounds concurrent decoding requests (the pool's
    batch dimension); ``prefill_micro`` bounds how many prompts prefill
    together. Both were admitted against ``budget_bytes`` through
    ``memory_model.serve_estimate``: ``base_bytes + kv_slot_bytes * slots
    + prefill_bytes_per_sample * micro`` never exceeds the budget. The
    fields are the JAX package's: on a data-parallel mesh the budget is
    per device and the pool is ``local_slots`` per worker
    (``max_decode_slots = local_slots * data_parallel``)."""
    max_decode_slots: int
    prefill_micro: int
    max_len: int  # context capacity per slot (prompt + generated)
    budget_bytes: int
    kv_slot_bytes: int
    base_bytes: int  # params + fixed overhead (independent of the slots)
    prefill_bytes_per_sample: int
    cache_bytes: int = 2
    global_window: Optional[int] = None
    ragged_prefill: bool = True  # False: exact-length prompt groups
    auto_slots: bool = True  # slot count chosen by the memory model
    data_parallel: int = 1
    local_slots: Optional[int] = None

    def __post_init__(self):
        if self.local_slots is None:
            object.__setattr__(self, "local_slots",
                               self.max_decode_slots // self.data_parallel)

    def modeled_peak_bytes(self, slots: Optional[int] = None,
                           prefill_micro: Optional[int] = None) -> int:
        """Memory-model peak with ``slots`` decode slots and a
        ``prefill_micro`` prefill in flight (defaults: the plan's bounds),
        per data-parallel worker."""
        s = self.local_slots if slots is None else slots
        m = self.prefill_micro if prefill_micro is None else prefill_micro
        return (self.base_bytes + self.kv_slot_bytes * s
                + self.prefill_bytes_per_sample * m)

    def describe(self) -> str:
        src = "memory model" if self.auto_slots else "pinned"
        group = "ragged-pad" if self.ragged_prefill else "exact-length"
        mesh = (f", data-parallel {self.data_parallel} x local "
                f"{self.local_slots}" if self.data_parallel > 1 else "")
        return (f"ServePlan: {self.max_decode_slots} decode slots @ max_len "
                f"{self.max_len} ({self.kv_slot_bytes / 2**20:.1f} MiB/slot, "
                f"{src}), prefill micro {self.prefill_micro} ({group}), "
                f"modeled peak {self.modeled_peak_bytes() / 2**30:.2f} GiB of "
                f"budget {self.budget_bytes / 2**30:.2f} GiB{mesh}")


def plan_serve(cfg: ModelConfig, *, budget_bytes: int, max_len: int,
               max_slots: Optional[int] = None,
               prefill_micro: Optional[int] = None,
               mesh=None, cache_bytes: int = 2, act_bytes: int = 2,
               global_window: Optional[int] = None,
               fsdp_params: bool = False,
               slot_cap: int = 256) -> ServePlan:
    """Admission planning for serving — ``plan_mbs`` with KV-slot costs.

    A pinned ``max_slots`` / ``prefill_micro`` is validated against the
    budget; otherwise the largest slot count whose modeled peak fits is
    admitted, halving the prefill micro-batch (from 8, floor 1) while its
    activations would leave fewer slots than the micro-batch itself.
    ``mesh`` reads ``budget_bytes`` as PER-DEVICE bytes (params discounted
    by the sharding ratio; ``fsdp_params=False`` models the replicating
    data-parallel replica) and plans ``local_slots`` per worker: one
    :class:`ServingEngine` a rank holds that many (``launch/serve.py`` on
    a world of ranks). ``slot_cap`` bounds the pool so a huge budget on a
    tiny config cannot plan an absurd batch dimension."""
    check_servable(cfg)
    if max_len < 2:
        raise ValueError(f"max_len must be >= 2 (prompt + one token), "
                         f"got {max_len}")
    dp = 1
    if mesh is not None:
        from ..launch import mesh as mesh_lib  # deferred: no cycle
        dp = mesh_lib.data_parallel_size(mesh)
    est = memory_model.serve_estimate(
        cfg, max_len, prefill_len=max_len, cache_bytes=cache_bytes,
        act_bytes=act_bytes, global_window=global_window, mesh=mesh,
        fsdp_params=fsdp_params)
    base = est.total(0, 0)

    def slots_at(pm: int) -> int:
        return (budget_bytes - est.total(0, pm)) // est.kv_slot_bytes

    if slots_at(1) < 1:
        need = est.total(1, 1)
        raise ValueError(
            f"{cfg.name}: budget {budget_bytes / 2**30:.2f} GiB cannot hold "
            f"the params + one decode slot + one prefill sample at max_len "
            f"{max_len} (needs {need / 2**30:.2f} GiB) — serving needs model "
            "parallelism or a shorter context; admission cannot shrink the "
            "model itself")

    auto_slots = max_slots is None
    if prefill_micro is not None:
        if prefill_micro < 1:
            raise ValueError(
                f"prefill_micro must be >= 1, got {prefill_micro}")
        pm = prefill_micro
    else:
        # start at 8 and halve while prefill activations would leave fewer
        # slots than the micro-batch: a prefill batch larger than the pool
        # it feeds is waste
        pm = 8
        while pm > 1 and slots_at(pm) < pm:
            pm //= 2

    if auto_slots:
        local = int(min(slots_at(pm), slot_cap))
        if local < 1:
            raise ValueError(
                f"{cfg.name}: prefill micro-batch {pm} leaves no room for a "
                f"decode slot in {budget_bytes / 2**30:.2f} GiB — shrink "
                "prefill_micro or raise the budget")
    else:
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        local = -(-max_slots // dp)
        peak = est.total(local, min(pm, local))
        if peak > budget_bytes:
            raise ValueError(
                f"{cfg.name}: pinned {max_slots} slots (local {local}) + "
                f"prefill micro {min(pm, local)} models "
                f"{peak / 2**30:.2f} GiB, over the "
                f"{budget_bytes / 2**30:.2f} GiB budget — "
                f"fits at most {slots_at(min(pm, local))} local slots")
    pm = max(1, min(pm, local))
    return ServePlan(
        max_decode_slots=local * dp, prefill_micro=pm, max_len=max_len,
        budget_bytes=int(budget_bytes), kv_slot_bytes=est.kv_slot_bytes,
        base_bytes=base, prefill_bytes_per_sample=est.prefill_bytes_per_sample,
        cache_bytes=cache_bytes, global_window=global_window,
        ragged_prefill=transformer.supports_ragged_prefill(cfg),
        auto_slots=auto_slots, data_parallel=dp, local_slots=local)


def _sample(logits, generator: Optional[torch.Generator],
            temperature: float):
    """Greedy (temperature 0) or temperature sampling over (..., V).

    Sampling draws from ``generator`` through ``torch.multinomial``: for
    one seed it gives another stream than the JAX package's
    ``jax.random.categorical``, so sampled tokens agree in distribution,
    not one by one. Greedy tokens agree one by one."""
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        return torch.multinomial(flat, 1, generator=generator).reshape(
            probs.shape[:-1])
    return torch.argmax(logits, dim=-1)


def _percentiles(xs: Sequence[float]) -> Dict[str, float]:
    if not len(xs):
        return {"p50": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0}
    a = np.asarray(xs, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(a.mean()), "max": float(a.max())}


class ServingEngine:
    """Continuous-batching scheduler over a :class:`KVPool`.

    One engine is one device pool of ``plan.local_slots`` slots (all of
    ``plan.max_decode_slots`` on one device; a data-parallel plan's share
    of one worker) and one decode step over the whole pool. The current
    tokens and positions of every slot stay on the device; a step samples
    (greedy at ``temperature == 0``, else at ``temperature``) on the
    device and reads back only the (S,) next tokens, which is also the
    step's latency fence."""

    def __init__(self, params, cfg: ModelConfig, plan: ServePlan, *,
                 dtype=torch.float32, cache_dtype=None,
                 temperature: float = 0.0, seed: int = 0, donate: bool = True,
                 pad_multiple: int = 16):
        check_servable(cfg)
        self.params = params
        self.cfg = cfg
        self.plan = plan
        self.dtype = dtype
        self.temperature = float(temperature)
        self.pad_multiple = int(pad_multiple)
        self.donate = donate
        self.device = tree.leaves(params)[0].device
        if cache_dtype is None:
            cache_dtype = (torch.bfloat16 if plan.cache_bytes == 2
                           else torch.float32)
        self.pool = KVPool(cfg, plan.local_slots, plan.max_len,
                           dtype=cache_dtype, global_window=plan.global_window,
                           donate=donate, device=self.device)
        S = plan.local_slots
        self._tok = torch.zeros((S, 1), dtype=torch.long, device=self.device)
        self._pos = torch.zeros((S,), dtype=torch.int32, device=self.device)
        self._by_slot: Dict[int, Request] = {}
        self._queue: collections.deque = collections.deque()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.metrics: Dict[str, Any] = {
            "warmup_s": 0.0,
            "prefill_latency_s": [],  # per prefill micro-batch
            "prefill_prompt_tokens": 0,
            "decode_steps": 0,
            "decode_tokens": 0,  # decode-issued tokens only (no prefill token)
            "decode_step_s": [],  # (wall seconds, active slots) per step
            "admitted": 0,
            "finished": 0,
            "max_concurrent": 0,
        }

    # -- model calls --------------------------------------------------------

    def _prefill(self, toks: np.ndarray, lengths: np.ndarray):
        """(logits (m, V), cache) of one prefill micro-batch: right-padded
        to its rows' ``lengths``, or (exact-length groups) of one length,
        when ``lengths`` goes unused."""
        if self.plan.ragged_prefill:
            lengths = torch.from_numpy(lengths).to(self.device)
        else:
            lengths = None
        return transformer.prefill(
            self.params, self.cfg, torch.from_numpy(toks).to(self.device),
            self.plan.max_len, dtype=self.dtype,
            global_window=self.plan.global_window, lengths=lengths)

    def _decode_logits(self):
        """Logits (S, V) of one decode step over the whole pool at the
        slots' current tokens and positions; writes the pool in place
        (``donate=False``: into a fresh copy that replaces it)."""
        cache = self.pool.cache
        if not self.donate:
            cache = tree.map(torch.clone, cache)
        logits, self.pool.cache = transformer.decode_step(
            self.params, self.cfg, self._tok, cache, self._pos,
            dtype=self.dtype, global_window=self.plan.global_window)
        return logits[:, 0]

    # -- admission ----------------------------------------------------------

    def submit(self, req: Request, now: float = 0.0) -> None:
        """Queue a request. The prompt must leave room for at least one
        generated token; max_new_tokens is clamped to the slot's context
        capacity (past it a global ring would silently become a sliding
        window, so the engine refuses instead)."""
        L = req.prompt_len
        if L < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        if L >= self.plan.max_len:
            raise ValueError(
                f"request {req.rid}: prompt length {L} >= plan.max_len "
                f"{self.plan.max_len} — no capacity left to generate")
        req.max_new_tokens = min(req.max_new_tokens, self.plan.max_len - L)
        req.state = QUEUED
        req.queued_s = now
        self._queue.append(req)

    def _next_group(self) -> List[Request]:
        """The next prefill micro-batch: FIFO, up to min(prefill_micro,
        free slots); exact-length families take only requests of the head
        request's prompt length (the head always qualifies, so none
        starves)."""
        k = min(self.plan.prefill_micro, self.pool.free_count,
                len(self._queue))
        if k < 1:
            return []
        if self.plan.ragged_prefill:
            return [self._queue.popleft() for _ in range(k)]
        head_len = self._queue[0].prompt_len
        group, keep = [], []
        for r in self._queue:
            if len(group) < k and r.prompt_len == head_len:
                group.append(r)
            else:
                keep.append(r)
        self._queue = collections.deque(keep)
        return group

    def _bucket_len(self, prompt_len: int) -> int:
        if not self.plan.ragged_prefill:
            return prompt_len  # an exact-length group has no padding
        b = self.pad_multiple * math.ceil(prompt_len / self.pad_multiple)
        return min(b, self.plan.max_len - 1)

    def _prefill_group(self, group: List[Request], now: float) -> float:
        """PREFILL: batch the group (padded to prefill_micro rows, as the
        JAX package does so that its bucket count bounds its compiles),
        sample each row's first token, copy cache rows into free slots."""
        m = self.plan.prefill_micro
        bucket = self._bucket_len(max(r.prompt_len for r in group))
        toks = np.zeros((m, bucket), np.int32)
        lengths = np.ones((m,), np.int32)
        for i, r in enumerate(group):
            r.state = PREFILL
            toks[i, :r.prompt_len] = r.prompt
            lengths[i] = r.prompt_len
        t0 = time.perf_counter()
        logits, cache = self._prefill(toks, lengths)
        first = _sample(logits, self._gen, self.temperature).cpu().numpy()
        dt = time.perf_counter() - t0
        t_tok = now + dt
        for i, r in enumerate(group):
            slot = self.pool.alloc()
            self.pool.insert(cache, i, slot)
            r.slot = slot
            r.tokens.append(int(first[i]))
            r.first_token_s = t_tok
            r.state = DECODE
            self._tok[slot, 0] = int(first[i])
            self._pos[slot] = r.prompt_len
            self._by_slot[slot] = r
            self.metrics["admitted"] += 1
            self.metrics["prefill_prompt_tokens"] += r.prompt_len
            if len(r.tokens) >= r.max_new_tokens:
                self._finish(r, t_tok)
        del cache
        self.metrics["prefill_latency_s"].append(dt)
        self.metrics["max_concurrent"] = max(self.metrics["max_concurrent"],
                                             len(self._by_slot))
        return dt

    # -- decode ------------------------------------------------------------

    @torch.inference_mode()
    def _decode_once(self, now: float) -> float:
        """One continuous-batching step over the whole pool. Only active
        slots' tokens are recorded and counted (never the prefill token);
        inactive lanes are dropped on the host."""
        t0 = time.perf_counter()
        nxt = _sample(self._decode_logits(), self._gen, self.temperature)
        self._tok[:, 0] = nxt
        self._pos += 1
        nxt_np = nxt.cpu().numpy()  # the one readback: the latency fence
        dt = time.perf_counter() - t0
        t_tok = now + dt
        active = list(self._by_slot.items())
        for slot, r in active:
            r.tokens.append(int(nxt_np[slot]))
            if len(r.tokens) >= r.max_new_tokens:
                self._finish(r, t_tok)
        self.metrics["decode_steps"] += 1
        self.metrics["decode_tokens"] += len(active)
        self.metrics["decode_step_s"].append((dt, len(active)))
        return dt

    def _finish(self, req: Request, now: float) -> None:
        """FINISHED: evict — the slot returns to the free list and is
        reusable at once (the next admission overwrites the row)."""
        req.state = FINISHED
        req.finish_s = now
        self.pool.free(req.slot)
        self._by_slot.pop(req.slot, None)
        self.metrics["finished"] += 1

    # -- loop --------------------------------------------------------------

    def warmup(self, prompt_lens: Sequence[int] = ()) -> float:
        """One decode step and one prefill per bucket before the clock
        starts (the library's first calls: handles, allocator pools).
        Garbage written into the empty pool is harmless: admission
        overwrites whole rows."""
        if self._by_slot:
            raise RuntimeError("warmup() must run before traffic is admitted")
        t0 = time.perf_counter()
        self._decode_logits().cpu()
        m = self.plan.prefill_micro
        for bucket in sorted({self._bucket_len(L) for L in prompt_lens}):
            logits, cache = self._prefill(np.zeros((m, bucket), np.int32),
                                          np.ones((m,), np.int32))
            logits.cpu()
            del logits, cache  # discarded, never inserted
        dt = time.perf_counter() - t0
        self.metrics["warmup_s"] += dt
        return dt

    def run(self, requests: Iterable[Request], *, warmup: bool = True,
            warmup_prompt_lens: Sequence[int] = ()) -> Dict[str, Any]:
        """Drive the lifecycle over a request stream ordered by
        ``arrival_s``. Per turn: admit due arrivals, run at most one
        prefill micro-batch if slots are free, then one decode step over
        the pool — so new prompts prefill between decode steps of admitted
        ones (continuous batching, not static waves)."""
        it: Iterator[Request] = iter(requests)
        pending = next(it, None)
        if warmup:
            lens = list(warmup_prompt_lens)
            if not lens and pending is not None:
                lens = [pending.prompt_len]
            self.warmup(lens)
        t0 = time.perf_counter()
        while pending is not None or self._queue or self._by_slot:
            now = time.perf_counter() - t0
            while pending is not None and pending.arrival_s <= now:
                self.submit(pending, now)
                pending = next(it, None)
            progressed = False
            group = self._next_group()
            if group:
                now += self._prefill_group(group, now)
                progressed = True
            if self._by_slot:
                self._decode_once(now)
                progressed = True
            if not progressed and pending is not None:
                time.sleep(min(max(pending.arrival_s - now, 0.0), 0.002))
        return self.report()

    # -- reporting ---------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        """Aggregate metrics. Decode throughput is decode-issued tokens
        over decode wall time only (no prefill, no warmup); ITL weights
        each step's latency by the tokens it produced."""
        m = self.metrics
        decode_time = sum(dt for dt, _ in m["decode_step_s"])
        itl = np.repeat([dt for dt, _ in m["decode_step_s"]],
                        [n for _, n in m["decode_step_s"]])
        occupancy = _percentiles([n for _, n in m["decode_step_s"]])
        return {
            "warmup_s": m["warmup_s"],
            "requests": {"admitted": m["admitted"], "finished": m["finished"]},
            "prefill": {
                "batches": len(m["prefill_latency_s"]),
                "prompt_tokens": m["prefill_prompt_tokens"],
                "latency_s": _percentiles(m["prefill_latency_s"]),
            },
            "decode": {
                "steps": m["decode_steps"],
                "tokens": m["decode_tokens"],
                "time_s": decode_time,
                "tokens_per_s": (m["decode_tokens"] / decode_time
                                 if decode_time else 0.0),
                "itl_s": _percentiles(itl),
            },
            "slots": {
                "planned": self.plan.local_slots,
                "max_concurrent": m["max_concurrent"],
                "mean_active_per_step": occupancy["mean"],
            },
            "ttft_s": _percentiles([]),  # filled by finished_report
        }

    def finished_report(self, requests: Sequence[Request]) -> Dict[str, Any]:
        """report() plus TTFT percentiles over a finished request list."""
        rep = self.report()
        rep["ttft_s"] = _percentiles(_ttfts(requests))
        return rep

    def samples(self, requests: Sequence[Request]) -> Dict[str, List[float]]:
        """The samples the report's percentiles are taken over (prefill
        latencies, ITL weighted by the tokens of each step, TTFT of
        ``requests``), for a report over several engines
        (:func:`merge_reports`)."""
        m = self.metrics
        return {"prefill_latency_s": list(m["prefill_latency_s"]),
                "itl_s": [dt for dt, n in m["decode_step_s"]
                          for _ in range(n)],
                "ttft_s": _ttfts(requests)}


def _ttfts(requests: Sequence[Request]) -> List[float]:
    return [r.first_token_s - r.arrival_s for r in requests
            if r.first_token_s is not None]


def merge_reports(reports: Sequence[Dict[str, Any]],
                  samples: Sequence[Dict[str, List[float]]],
                  plan: ServePlan) -> Dict[str, Any]:
    """One report over the engines of a world (one a rank, each its
    ``finished_report`` and :meth:`ServingEngine.samples`), in the
    reference's keys: requests, prefill batches and tokens, decode steps
    and tokens summed; decode tokens/s summed over the engines (each over
    its own decode time; ``time_s`` is the longest); latency, ITL and
    TTFT percentiles over every engine's samples; peak concurrency and
    mean active slots summed; the plan's slots over all workers."""
    def pooled(key):
        return _percentiles([x for s in samples for x in s[key]])

    def total(section, key):
        return sum(r[section][key] for r in reports)
    return {
        "warmup_s": max(r["warmup_s"] for r in reports),
        "requests": {k: total("requests", k)
                     for k in ("admitted", "finished")},
        "prefill": {"batches": total("prefill", "batches"),
                    "prompt_tokens": total("prefill", "prompt_tokens"),
                    "latency_s": pooled("prefill_latency_s")},
        "decode": {"steps": total("decode", "steps"),
                   "tokens": total("decode", "tokens"),
                   "time_s": max(r["decode"]["time_s"] for r in reports),
                   "tokens_per_s": total("decode", "tokens_per_s"),
                   "itl_s": pooled("itl_s")},
        "slots": {"planned": plan.max_decode_slots,
                  "max_concurrent": total("slots", "max_concurrent"),
                  "mean_active_per_step": total("slots",
                                                "mean_active_per_step")},
        "ttft_s": pooled("ttft_s"),
        "engines": len(reports)}


def synthetic_traffic(n_requests: int, *, rate_rps: float,
                      prompt_lens: Sequence[int], new_tokens: Sequence[int],
                      vocab_size: int, seed: int = 0) -> Iterator[Request]:
    """Synthetic heavy traffic: Poisson arrivals (exponential gaps at
    ``rate_rps`` requests/s), prompt lengths and output budgets drawn
    uniformly from the given mixes. numpy, so one seed gives the JAX
    package's requests exactly."""
    rng = np.random.default_rng(seed)
    t = 0.0
    for rid in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        L = int(rng.choice(prompt_lens))
        yield Request(
            rid=rid,
            prompt=rng.integers(0, vocab_size, (L,), dtype=np.int32),
            max_new_tokens=int(rng.choice(new_tokens)),
            arrival_s=t)
